"""Optimizers and the LM training step of the port (``repro.train``):
AdamW and SNES for the NEP-SPIN fit, and ``train_step`` (gradient
accumulation + one AdamW update) for the LM zoo's attention families.  The
ssm and hybrid families wait for the SSD backward kernel (ROADMAP §1 item
15.6b); data-parallel training on ``torch.distributed`` is item 15.6c."""
