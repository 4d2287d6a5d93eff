"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 - pixtral-ViT + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

The ViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, S_img, d) fused ahead of the text tokens.
"""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, act="swiglu", norm="rmsnorm",
        rope_theta=1e9, frontend="vit", frontend_frac=0.25,
        source="hf:mistralai/Pixtral-12B-2409",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, act="swiglu", norm="rmsnorm",
        frontend="vit", frontend_frac=0.25, dtype="float32",
    )
