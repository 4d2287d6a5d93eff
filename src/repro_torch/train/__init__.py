"""Optimizers of the port (``repro.train``): AdamW and SNES for the NEP-SPIN
fit.  The LM zoo's serving path is ported (``models/``); its training step
(``train_step``, with ``chunked_xent`` and ``make_loss_fn``) is ROADMAP
queue 1 item 15.6."""
