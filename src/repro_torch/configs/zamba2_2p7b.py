"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 - Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

Shared attn+MLP block (weight-tied) is applied every 6 mamba blocks; its
input is h + the embedding residual (additive approximation of zamba2's
concat-reproject; documented in DESIGN.md)."""
from repro_torch.models.config import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, kv_heads=32, head_dim=80,
        d_ff=10240, vocab=32000, act="swiglu", norm="rmsnorm",
        shared_every=6,
        ssm=SSMCfg(d_state=64, head_dim=64, expand=2, conv_width=4,
                   n_groups=1, chunk=128),
        source="arXiv:2411.15242",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, act="swiglu", norm="rmsnorm",
        shared_every=2,
        ssm=SSMCfg(d_state=16, head_dim=16, expand=2, conv_width=4,
                   n_groups=1, chunk=16),
        dtype="float32",
    )
