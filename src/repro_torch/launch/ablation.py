#!/usr/bin/env python3
"""Single-device optimisation ablation, the paper's Fig. 5 (port of
``benchmarks/ablation.py``).

    PYTHONPATH=src python -m repro_torch.launch.ablation [--smoke]
        [--device cuda|cpu] [--out DIR]

Structural variants of one NEP-SPIN force evaluation, the reference's:

  unfused-3pass   three autograd traversals: the energy, the forces and the
                  field as separate calls (the NEP-SPIN baseline)
  fused-autodiff  one traversal: the gradient in positions and spins at once
                  (spin-radial force fusion)
  fused-2pass     the kernels' two-pass algorithm in plain torch
                  (:func:`fused_2pass`; its force is partial, see there)
  pruned-M        the table cut to the exact max coordination instead of
                  capacity 96 (pre-staging)

plus a ``max_coordination`` row.  B20 FeGe at 300 K, the production spec,
f32; the reference's 6^3 unit cells on the CPU and under ``--smoke``,
16^3 (32,768 atoms) on the card.  The reference builds its tables with the
all-pairs ``dense_neighbor_table`` (O(N^2) memory); above 8^3 the same table
comes from ``md/neighbor.py:cell_neighbor_table``.  The tables are built
outside the timed calls.  CSV derived column: the speed-up against
``unfused-3pass``.  Writes ``ablation.json`` under ``--out``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch import bench_common as bc

CAPACITY = 96
CARD_CELLS = 16


def fused_2pass(spec, params, pos, spin, types, table, box):
    """The reference's plain rendering of the kernels' two-pass algorithm
    (``benchmarks/ablation.py:_fused_2pass``), ported as it is, for the
    timing row: ``(E, f, h)`` with ``E`` the energy, ``h = -dE/dS_i`` at
    fixed neighbour spins (the direct term alone), and ``f = sum_j
    dE/ddr_ij`` over each atom's own slots, the distances held fixed.  ``f``
    is *not* the force: the fold-back of the neighbours' reactions, which
    the kernels do through ``idx``, is left out, as in the reference."""
    from repro_torch.core.descriptor import (accumulate, finalize,
                                             init_accumulators)
    from repro_torch.core.potential import mlp_energy
    from repro_torch.md.neighbor import gather_neighbors
    dr, dist, sj, tj, mask = gather_neighbors(pos, spin, types, table, box)
    dp = params.desc_params()
    dr = dr.detach().requires_grad_(True)
    si = spin.detach().requires_grad_(True)
    sj = sj.detach().requires_grad_(True)
    dist = dist.detach()
    with torch.enable_grad():
        acc = init_accumulators(spec, (pos.shape[0],), pos.dtype, pos.device)
        acc = accumulate(spec, dp, acc, dr, dist, mask, types, tj, si, sj)
        e = torch.sum(mlp_energy(params, finalize(spec, acc, si), types))
        g_dr, g_si, _ = torch.autograd.grad(e, (dr, si, sj))
    return e.detach(), torch.sum(g_dr, dim=1), -g_si


def setup(device, cells: int):
    """(spec, params, state, loose table, tight table, max coordination):
    the reference's seeds and spec (:func:`bench_common.neighbor_table`'s
    tables)."""
    spec, params = bc.nep_model(device, 1)
    st = bc.b20_state(device, cells, 300.0, 0)
    loose = bc.neighbor_table(st, cells, spec.cutoff, CAPACITY)
    max_coord = int(loose.mask.sum(1).max())
    return (spec, params, st, loose,
            bc.neighbor_table(st, cells, spec.cutoff, max_coord), max_coord)


def variants(spec, params, st, loose, tight) -> dict:
    """name -> a call of (pos, spin) returning (E, F-or-f, H)."""
    from repro_torch.core.potential import energy, energy_forces_field
    types, box = st.types, st.box

    def e_of(p, s):
        return energy(spec, params, p, s, types, loose, box)

    def unfused(pos, spin):
        with torch.enable_grad():
            e = e_of(pos, spin).detach()
            p = pos.detach().requires_grad_(True)
            f = -torch.autograd.grad(e_of(p, spin), p)[0]
            s = spin.detach().requires_grad_(True)
            h = -torch.autograd.grad(e_of(pos, s), s)[0]
        return e, f, h

    return {
        "unfused-3pass": unfused,
        "fused-autodiff": lambda pos, spin: energy_forces_field(
            spec, params, pos, spin, types, loose, box),
        "fused-2pass": lambda pos, spin: fused_2pass(
            spec, params, pos, spin, types, loose, box),
        "pruned-M": lambda pos, spin: energy_forces_field(
            spec, params, pos, spin, types, tight, box),
    }


def run(device="cuda") -> dict:
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    cells = CARD_CELLS if dev.type == "cuda" and not bc.smoke() else 6
    spec, params, st, loose, tight, max_coord = setup(dev, cells)
    calls = variants(spec, params, st, loose, tight)
    out = {"device": str(dev), "cells": cells,
           "n_atoms": int(st.pos.shape[0]), "capacity": CAPACITY,
           "max_coordination": max_coord, "variants": {}}
    rows = []
    bc.reset_peak(dev)
    t0 = None
    for name, fn in calls.items():
        t = bc.timeit(fn, st.pos, st.spin, device=dev)
        t0 = t if t0 is None else t0
        out["variants"][name] = {"s": t, "speedup": t0 / t}
        rows.append(bc.row(f"ablation/{name}", t * 1e6, f"{t0 / t:.2f}x"))
    rows.append(bc.row("ablation/max_coordination", max_coord,
                       f"capacity{CAPACITY}->{max_coord}"))
    out["peak_gib"] = bc.peak_gib(dev)
    out["rows"] = rows
    return out


def main(argv=None) -> dict:
    args = bc.parse(bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0])), argv)
    with bc.switches(args):
        out = run(args.device)
    bc.write_json(args.out / "ablation.json", out)
    return out


if __name__ == "__main__":
    main()
