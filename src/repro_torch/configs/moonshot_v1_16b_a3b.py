"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff(expert)=1408
vocab=163840, MoE 64 routed top-6 + shared - kimi/moonlight
[hf:moonshotai/Moonlight-16B-A3B; hf]. First layer dense (d_ff 11264)."""
from repro_torch.models.config import ArchConfig, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, kv_heads=16, head_dim=128,
        d_ff=11264, vocab=163840, act="swiglu", norm="rmsnorm",
        moe=MoECfg(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                   router="sigmoid", capacity_factor=1.25, first_dense=1,
                   d_ff_dense=11264),
        rope_theta=50000.0,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, act="swiglu", norm="rmsnorm",
        moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                   router="sigmoid", capacity_factor=1.5, first_dense=1,
                   d_ff_dense=128),
        dtype="float32",
    )
