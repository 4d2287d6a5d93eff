"""Optimizers and the LM training step of the port (``repro.train``):
AdamW and SNES for the NEP-SPIN fit, and ``train_step`` (gradient
accumulation + one AdamW update) for every family of the LM zoo.
Data-parallel training on ``torch.distributed`` is item 15.6c."""
