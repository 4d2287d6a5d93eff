"""Architecture configuration schema for the LM zoo (a copy of
``repro.models.config``: data only, shared by every config module)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int = 0            # routed experts
    top_k: int = 1
    n_shared: int = 0             # always-on shared experts
    d_ff_expert: int = 0
    router: str = "softmax"       # 'softmax' | 'sigmoid' (deepseek aux-free)
    capacity_factor: float = 1.25
    first_dense: int = 0          # leading layers that stay dense
    d_ff_dense: int = 0           # d_ff of those dense layers (0 -> d_ff)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 128              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class MLACfg:
    """DeepSeek multi-head latent attention."""
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 32000
    act: str = "swiglu"           # swiglu | gelu | relu2
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 = full attention
    tie_embeddings: bool = False
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    mla: MLACfg | None = None
    # hybrid (zamba2): shared attention block every `shared_every` layers
    shared_every: int = 0
    # encoder-decoder (seamless)
    encoder_layers: int = 0
    # modality frontend stub: tokens replaced by precomputed embeddings
    frontend: str | None = None   # None | 'audio' | 'vit'
    # fraction of positions that are stub-embedding inputs (vlm)
    frontend_frac: float = 0.25
    dtype: str = "bfloat16"
    # MoE dispatch: 'auto' (shard_map EP under a mesh), 'dense', 'ep'
    moe_impl: str = "auto"
    # --- notes for DESIGN.md provenance ---
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / hybrid / SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def n_params(self) -> int:
        """Approximate parameter count (for MODEL_FLOPS and sanity checks)."""
        d = self.d_model
        p = self.vocab * d * (1 if self.tie_embeddings else 2)
        for li in range(self.n_layers):
            p += self._layer_params(li)
        if self.encoder_layers:
            for li in range(self.encoder_layers):
                p += self._layer_params(li, cross=False, enc=True)
            # decoder cross-attention
            p += self.n_layers * 4 * d * self.n_heads * self.hd
        if self.shared_every:
            # one shared attn+mlp block (weights tied across invocations)
            p += 4 * d * self.n_heads * self.hd + 3 * d * self.d_ff
            p -= self.n_layers // self.shared_every * (
                4 * d * self.n_heads * self.hd + 3 * d * self.d_ff)
        return int(p)

    def _layer_params(self, li: int, cross=False, enc=False) -> int:
        d = self.d_model
        p = 0
        if self.ssm is not None and not enc:
            din = self.ssm.expand * d
            nh = din // self.ssm.head_dim
            p += d * (2 * din + 2 * self.ssm.n_groups * self.ssm.d_state
                      + nh) + din * d + din * self.ssm.conv_width
            if self.family == "ssm":
                return p
        if self.mla is not None:
            m = self.mla
            p += d * m.q_lora + m.q_lora * self.n_heads * (m.qk_nope
                                                           + m.qk_rope)
            p += d * (m.kv_lora + m.qk_rope)
            p += m.kv_lora * self.n_heads * (m.qk_nope + m.v_head)
            p += self.n_heads * m.v_head * d
        elif self.n_heads and self.ssm is None:
            p += d * self.n_heads * self.hd + 2 * d * self.kv_heads * self.hd
            p += self.n_heads * self.hd * d
        if self.moe is not None and not enc and li >= self.moe.first_dense:
            mult = 3 if self.act == "swiglu" else 2
            p += (self.moe.n_experts + self.moe.n_shared) * mult * d * \
                self.moe.d_ff_expert
            p += d * self.moe.n_experts  # router
        elif self.d_ff:
            mult = 3 if self.act == "swiglu" else 2
            dff = self.d_ff
            if self.moe is not None and li < self.moe.first_dense:
                dff = self.moe.d_ff_dense or self.d_ff
            p += mult * d * dff
        return p

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        mult = 3 if self.act == "swiglu" else 2
        dead = (self.moe.n_experts - self.moe.top_k) * mult * d * \
            self.moe.d_ff_expert
        dead *= max(self.n_layers - self.moe.first_dense, 0)
        return int(self.n_params() - dead)
