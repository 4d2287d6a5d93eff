"""NEP-SPIN evaluation through the kernels (port of ``repro.kernels.nep.ops``).

One force call:
  1. gather the neighbor spins ``sj = spin[idx]``;
  2. K1: descriptor + MLP energy + packed adjoint accumulators per atom;
  3. K2: fused force + torque in one neighbor traversal; it reads each
     neighbor's adjoint row itself through ``idx``, so the (N, M, A)
     gathered adjoint block of the reference is never built;
  4. the Zeeman term in closed form (the external field is not learned).

No padding to a tile multiple: the CUDA kernels mask their own ragged edge.

A replica batch (the Replicated plan: ``nbh.dr`` (R, N, M, 3), ``spin``
(R, N, 3), ``field`` (R, 3), one shared table) takes one gather
``spin[:, idx]``, one K1 and one K2 launch for all R, and returns energies
(R,), forces and fields (R, N, 3); each replica's numbers are bitwise those
of a flat call on its own inputs (each replica's sums are taken on their
own, in the flat call's order).
"""
from __future__ import annotations

import torch

from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.potential import NEPSpinParams, zeeman_moments
from repro_torch.kernels.nep.kernel import nep_atom_pass, nep_force_pass
from repro_torch.md.neighbor import NeighborTable, Neighborhood, gather_blocks
from repro_torch.utils import units


def _replica_sum(x: torch.Tensor, batched: bool) -> torch.Tensor:
    """``torch.sum(x)``, or for a replica batch each replica's sum (R,),
    each taken on a fresh copy of its rows: the reduction then runs as it
    would on a flat tensor of the same size, so its order, and its bits, are
    the flat call's."""
    if not batched:
        return torch.sum(x)
    return torch.stack([torch.sum(x[r].clone()) for r in range(x.shape[0])])


def nep_compute(spec: NEPSpinSpec, params: NEPSpinParams, nbh: Neighborhood,
                spin: torch.Tensor, types: torch.Tensor, field=None,
                moments=None):
    """``(E, F, H_eff)`` from pre-gathered neighbor blocks via K1 and K2
    (flat, or a replica batch: module docstring)."""
    batched = spin.dim() == 3
    idx = nbh.idx.long()
    sj = spin[:, idx] if batched else spin[idx]
    e, hdir, abar = nep_atom_pass(spec, params, nbh.dr, nbh.mask, types,
                                  nbh.tj, spin, sj)
    force, h2 = nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                               nbh.tj, spin, sj, abar)
    energy = _replica_sum(e, batched)
    heff = hdir + h2
    if field is not None:
        mom = zeeman_moments(moments, types, spin)[:, None]
        b = torch.as_tensor(field, dtype=spin.dtype, device=spin.device)
        if batched:
            b = b[..., None, :]
        energy = energy - units.MU_B * _replica_sum(mom * spin * b, batched)
        heff = heff + units.MU_B * mom * b
    return energy, force, heff


def nep_energy_forces_field(spec: NEPSpinSpec, params: NEPSpinParams,
                            pos: torch.Tensor, spin: torch.Tensor,
                            types: torch.Tensor, table: NeighborTable,
                            box: torch.Tensor, field=None, moments=None):
    """Whole evaluation from a table: :func:`gather_blocks` then
    :func:`nep_compute`."""
    return nep_compute(spec, params, gather_blocks(pos, types, table, box),
                       spin, types, field, moments)
