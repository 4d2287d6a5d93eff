"""PyTorch/CUDA port of the spin-lattice MD stack and the LM zoo (``repro``).

The module layout mirrors ``repro`` so every module here has one reference
module there.  This package imports ``torch`` and numpy only; hand-written
CUDA kernels (``kernels/{nep,ssd,attention}/csrc``) replace the Pallas
kernels and are built on first use by :mod:`repro_torch._build`.

Entry points take ``device="cuda"`` by default and raise when no card is
present; pass ``device="cpu"`` to run on the host (the kernels' wrappers then
dispatch to their plain PyTorch versions).
"""
