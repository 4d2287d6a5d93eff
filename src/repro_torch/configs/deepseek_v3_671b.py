"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 1 shared + 256 routed top-8, MLA (kv_lora 512 + rope 64),
first 3 layers dense (d_ff 18432), sigmoid aux-free router
[arXiv:2412.19437; hf].  MTP head omitted (training-objective add-on;
documented in DESIGN.md).
"""
from repro_torch.models.config import ArchConfig, MLACfg, MoECfg


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, kv_heads=128, head_dim=128,
        d_ff=18432, vocab=129280, act="swiglu", norm="rmsnorm",
        mla=MLACfg(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                   v_head=128),
        moe=MoECfg(n_experts=256, top_k=8, n_shared=1, d_ff_expert=2048,
                   router="sigmoid", capacity_factor=1.25, first_dense=3,
                   d_ff_dense=18432),
        rope_theta=10000.0,
        source="arXiv:2412.19437",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, act="swiglu", norm="rmsnorm",
        mla=MLACfg(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8, v_head=16),
        moe=MoECfg(n_experts=8, top_k=2, n_shared=1, d_ff_expert=32,
                   router="sigmoid", capacity_factor=1.5, first_dense=1,
                   d_ff_dense=128),
        dtype="float32",
    )
