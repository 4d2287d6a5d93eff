"""Model and run configurations.

``get(name)`` returns the full ``ArchConfig`` of an LM the port runs and
``get_smoke(name)`` its reduced same-family config for CPU tests (the
registry of ``repro.configs``, limited to the ported archs).  The MD
workload lives in :mod:`repro_torch.configs.fege_spinlattice`.
"""
from __future__ import annotations

import importlib

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]

# archs of the reference registry that the port does not run yet, with the
# ROADMAP item that ports them
NOT_PORTED = {
    "h2o-danube-3-4b": "ROADMAP §1 item 15 (dense family)",
    "qwen2-7b": "ROADMAP §1 item 15 (dense family)",
    "minitron-4b": "ROADMAP §1 item 15 (dense family)",
    "starcoder2-3b": "ROADMAP §1 item 15 (dense family)",
    "moonshot-v1-16b-a3b": "ROADMAP §1 item 15 (MoE)",
    "deepseek-v3-671b": "ROADMAP §1 item 15 (MoE + MLA)",
    "pixtral-12b": "ROADMAP §1 item 15 (vlm)",
    "seamless-m4t-large-v2": "ROADMAP §1 item 15 (encdec)",
}


def _module(name: str):
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet: "
                       f"{NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; ported: {ARCHS}")
    mod = name.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke_config()
