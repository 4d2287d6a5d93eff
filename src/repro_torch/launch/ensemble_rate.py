#!/usr/bin/env python3
"""Replica-batched chunks against sequential single-replica chunks (port
of ``benchmarks/ensemble.py``).

    PYTHONPATH=src python3 -m repro_torch.launch.ensemble_rate
        [--replicas 1,4,16] [--smoke] [--device cuda|cpu] [--out DIR]

For each R: a :class:`~repro_torch.ensemble.replica.ReplicaEnsemble` of R
copies of a 16x16x1 simple-cubic film (256 atoms each, Heisenberg-DMI, f32),
one 50-step chunk under a temperature ramp (95 -> 20 K) in a 25 T field,
timed as the median of 3 after a warm chunk (one chunk and no warm one
under ``--smoke`` or ``BENCH_SMOKE=1``), each ending in a synchronize.
Prints a CSV row per R (``ensemble/R=..``: us a chunk, atom-steps/s and the
speed-up against R sequential chunks of the R = 1 run, R x its time over
this one), then one JSON line, which also goes to ``ensemble_rate.json``
under ``--out`` (default ``build/bench/``).
The Heisenberg-DMI evaluation loops over the replicas in Python, so only
the integrator, the table and the observables are batched.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.launch import bench_common as bc

CHUNK = 50
CELLS = (16, 16, 1)


def _ensemble(n_replicas: int, device):
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.ensemble import protocol
    from repro_torch.ensemble.replica import ReplicaEnsemble, replicate
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.state import init_state
    lat = simple_cubic()
    st = init_state(lat, CELLS, spin_init="helix_x", generator=torch.Generator(
        device=device).manual_seed(0), device=device)
    cfg = IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.1)
    ens = ReplicaEnsemble(
        potential=HeisenbergDMIModel(d0=0.01), cfg=cfg,
        states=replicate(st, n_replicas),
        masses=torch.tensor(lat.masses, dtype=torch.float32, device=device),
        magnetic=torch.tensor(lat.moments, device=device) > 0, cutoff=5.0,
        capacity=8, diag_grid=(16, 16), pitch_bins=16, device=device)
    temp = protocol.linear(0.0, CHUNK * cfg.dt, 95.0, 20.0)
    field = protocol.constant(np.asarray([0.0, 0.0, 25.0], np.float32))
    return ens, temp, field, st.pos.shape[0]


def measure(device="cuda", replicas=(1, 4, 16), iters: int = 3) -> dict:
    """{R: {chunk_s, atom_steps_per_s, speedup_vs_sequential}}."""
    from repro_torch.ensemble.replica import spawn_generators
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    out, base = {}, None
    for r in replicas:
        ens, temp, field, n_atoms = _ensemble(r, dev)
        eng = ens._engine
        targ = eng._norm_arg(temp, vec=False)
        farg = eng._norm_arg(field, vec=True)
        gens = spawn_generators(1, r, dev)

        def chunk():
            c = eng._carry
            return eng._replica_chunk(
                c, gens, eng._chunk_arg(targ, c, CHUNK, vec=False),
                eng._chunk_arg(farg, c, CHUNK, vec=True), CHUNK, None)

        t = bc.timeit(chunk, device=dev, iters=iters)
        base = t if base is None else base
        out[r] = {"chunk_s": t, "atom_steps_per_s": r * n_atoms * CHUNK / t,
                  "speedup_vs_sequential": base * r / t}
        bc.row(f"ensemble/R={r}", t * 1e6,
               f"{out[r]['atom_steps_per_s']:.3e} atom-step/s|"
               f"{out[r]['speedup_vs_sequential']:.2f}x vs sequential")
    return out


def main(argv=None) -> dict:
    ap = bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    ap.add_argument("--replicas", default="1,4,16")
    args = bc.parse(ap, argv)
    with bc.switches(args):
        res = measure(args.device, tuple(int(x) for x in
                                         args.replicas.split(",")))
    print(json.dumps({"ensemble_rate": res}))
    bc.write_json(args.out / "ensemble_rate.json",
                  {"device": args.device, "chunk": CHUNK, "cells": CELLS,
                   "replicas": res})
    return res


if __name__ == "__main__":
    main()
