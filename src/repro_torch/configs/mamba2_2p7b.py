"""mamba2-2.7b [ssm]: 64L d_model=2560, attn-free, vocab=50280,
ssm_state=128 - SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ArchConfig, SSMCfg


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, d_ff=0, vocab=50280,
        ssm=SSMCfg(d_state=128, head_dim=64, expand=2, conv_width=4,
                   n_groups=1, chunk=128),
        norm="rmsnorm",
        source="arXiv:2405.21060",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, d_ff=0, vocab=256,
        ssm=SSMCfg(d_state=16, head_dim=16, expand=2, conv_width=4,
                   n_groups=1, chunk=16),
        norm="rmsnorm", dtype="float32",
    )
