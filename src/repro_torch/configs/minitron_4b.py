"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 - pruned nemotron (squared-ReLU MLP)
[arXiv:2407.14679; hf]."""
from repro_torch.models.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b", family="dense",
        n_layers=32, d_model=3072, n_heads=24, kv_heads=8, d_ff=9216,
        vocab=256000, act="relu2", norm="rmsnorm",
        source="arXiv:2407.14679",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="minitron-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, kv_heads=2, d_ff=128,
        vocab=512, act="relu2", norm="rmsnorm", dtype="float32",
    )
