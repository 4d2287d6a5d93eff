"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 - GQA, RoPE, LayerNorm+GELU [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b", family="dense",
        n_layers=30, d_model=3072, n_heads=24, kv_heads=2, d_ff=12288,
        vocab=49152, act="gelu", norm="layernorm", qkv_bias=True,
        rope_theta=1e5,
        source="arXiv:2402.19173",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=256, act="gelu", norm="layernorm", qkv_bias=True,
        dtype="float32",
    )
