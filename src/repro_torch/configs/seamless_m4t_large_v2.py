"""seamless-m4t-large-v2 [audio]: enc-dec, 24L(+24L) d_model=1024 16H
d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].

Backbone only: the audio frontend is a STUB - input_specs() supplies
precomputed frame embeddings to the encoder. Decoder target length is
S_src/4 (audio->text ratio; documented)."""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, encoder_layers=24, d_model=1024, n_heads=16,
        kv_heads=16, d_ff=8192, vocab=256206, act="gelu", norm="layernorm",
        frontend="audio",
        source="arXiv:2308.11596",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, encoder_layers=2, d_model=64, n_heads=4, kv_heads=4,
        d_ff=128, vocab=256, act="gelu", norm="layernorm",
        frontend="audio", dtype="float32",
    )
