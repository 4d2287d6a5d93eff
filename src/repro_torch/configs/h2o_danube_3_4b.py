"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 - llama+mistral mix, sliding-window attention
[arXiv:2401.16818; unverified]."""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, kv_heads=8, d_ff=10240,
        vocab=32000, act="swiglu", norm="rmsnorm",
        sliding_window=4096, rope_theta=10000.0,
        source="arXiv:2401.16818",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="danube3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=256, act="swiglu", norm="rmsnorm", sliding_window=16,
        dtype="float32",
    )
