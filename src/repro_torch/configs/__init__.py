"""Model and run configurations.

``get(name)`` returns the full ``ArchConfig`` of an LM and ``get_smoke(name)``
its reduced same-family config for CPU tests: the registry of
``repro.configs``, every arch of which the port serves.  The MD workload
lives in :mod:`repro_torch.configs.fege_spinlattice`.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "mamba2-2.7b",
    "h2o-danube-3-4b",
    "qwen2-7b",
    "minitron-4b",
    "starcoder2-3b",
    "pixtral-12b",
    "deepseek-v3-671b",
    "moonshot-v1-16b-a3b",
    "seamless-m4t-large-v2",
    "zamba2-2.7b",
]


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = name.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str):
    return _module(name).config()


def get_smoke(name: str):
    return _module(name).smoke_config()
