"""Accumulator layout shared by K1, K2 and their plain versions.

K1 writes the adjoint accumulators Abar_i = dE_i/dA_i of one atom as one
contiguous row of ``acc_width(spec)`` floats (182 at the production spec),
the leaves concatenated in :func:`acc_keys` order, each leaf row-major over
its tail.  K2 reads neighbor rows of that buffer through the table indices,
so a neighbor's adjoints are one contiguous load.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.descriptor import _MONO, NEPSpinSpec


def acc_keys(spec: NEPSpinSpec) -> list[str]:
    """Deterministic accumulator ordering (the reference's ``acc_keys``)."""
    keys = ["rad"] + [f"ang{p}" for p in range(spec.l_max + 1)]
    if spec.spin:
        keys += ["sp_dot", "sp_dmi", "sp_pd", "sp_v", "sp_w"]
    return keys


def acc_tails(spec: NEPSpinSpec) -> dict[str, tuple[int, ...]]:
    tails = {"rad": (spec.n_rad,)}
    for p in range(spec.l_max + 1):
        tails[f"ang{p}"] = (spec.n_ang, len(_MONO[p]))
    if spec.spin:
        tails.update(sp_dot=(spec.n_spin,), sp_dmi=(spec.n_spin,),
                     sp_pd=(spec.n_spin,), sp_v=(spec.n_spin, 3),
                     sp_w=(spec.n_spin, 3))
    return tails


def acc_width(spec: NEPSpinSpec) -> int:
    """Floats per atom in the packed accumulator row."""
    return sum(math.prod(t) for t in acc_tails(spec).values())


def unpack_abar(spec: NEPSpinSpec, flat: torch.Tensor) -> dict:
    """Views ``{key: (..., *tail)}`` of a packed (..., A) buffer."""
    out, o = {}, 0
    lead = flat.shape[:-1]
    for k, tail in acc_tails(spec).items():
        w = math.prod(tail)
        out[k] = flat[..., o:o + w].reshape(*lead, *tail)
        o += w
    return out


def pack_abar(spec: NEPSpinSpec, leaves: dict) -> torch.Tensor:
    """Inverse of :func:`unpack_abar`: (..., A) contiguous."""
    tails = acc_tails(spec)
    parts = []
    for k in acc_keys(spec):
        v = leaves[k]
        parts.append(v.reshape(*v.shape[:v.ndim - len(tails[k])], -1))
    return torch.cat(parts, dim=-1).contiguous()
