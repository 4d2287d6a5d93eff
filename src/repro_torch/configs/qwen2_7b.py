"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 - GQA with QKV bias [arXiv:2407.10671; hf]."""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-7b", family="dense",
        n_layers=28, d_model=3584, n_heads=28, kv_heads=4, d_ff=18944,
        vocab=152064, act="swiglu", norm="rmsnorm", qkv_bias=True,
        rope_theta=1e6,
        source="arXiv:2407.10671",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=160,
        vocab=256, act="swiglu", norm="rmsnorm", qkv_bias=True,
        dtype="float32",
    )
