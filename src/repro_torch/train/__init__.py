"""Optimizers and the LM training step of the port (``repro.train``):
AdamW and SNES for the NEP-SPIN fit, and ``train_step`` (gradient
accumulation + one AdamW update) for every family of the LM zoo, on one
device or on a mesh (DTensor parameters: dp, tp and fsdp, ZeRO-1
moments, one gradient reduction a step)."""
