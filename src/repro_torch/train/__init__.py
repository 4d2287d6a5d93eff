"""Optimizers of the port (``repro.train``): AdamW and SNES for the NEP-SPIN
fit.  The LM training step (``train_step``) is ROADMAP queue 1 item 15.6."""
