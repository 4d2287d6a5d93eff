"""Device resolution shared by every entry point."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` (a bare ``"cuda"`` resolves to the
    current card's index); raises if CUDA is asked for but absent.

    Entry points default to ``"cuda"`` and never move work to the host on
    their own: running on the CPU takes an explicit ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host")
        if dev.index is None:   # compare equal to the tensors' cuda:N
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
