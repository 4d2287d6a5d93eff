"""One field-cooled chunk of the Engine on the Sharded plan, on one or more
ranks (port of ``repro.launch.md_step``'s engine half).

    PYTHONPATH=src python -m repro_torch.launch.md_step [--cells 8 6 6]
        [--steps 40] [--chunk 20] [--kernel] [--nproc 2] [--backend gloo]
        [--halo-mode auto] [--check-flat] [--device cuda]

Simple cubic ``--cells`` under ``protocol.field_cooling`` (160 K -> 40 K,
0.1 T) through ``Engine(plan=Sharded())``: Heisenberg-DMI, or with
``--kernel`` NEP-SPIN at the smoke spec through K1/K2 and the q_Fp halo.
One warm chunk, then ``--steps`` timed.  ``--nproc`` ranks are spawned with
``torch.multiprocessing`` and meet at a ``file://`` rendezvous
(``--backend``: ``nccl`` puts rank r on card r, ``gloo`` may share one
card, in allgather mode, with its messages through the host - no scaling
figure; ``--halo-mode`` as ``Sharded.halo_mode``).  Rank 0 prints the
steps/s, rebuilds, migrations, the halo ledger and the charge trace, then
one JSON line.  ``--check-flat`` runs f64 NVE instead (no thermostat, no schedule)
and rank 0 then runs the flat Engine from the same state for as many
steps: ``vs_flat`` is the largest |difference| of pos, vel and spin.  The
dry-run half of the reference module (lowering and cost analysis) is
ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import argparse
import json
import time


def run_engine_chunk(cells=(8, 6, 6), steps: int = 40, chunk: int = 20,
                     temperature: float = 160.0, kernel: bool = False,
                     seed: int = 0, device: str = "cuda",
                     halo_mode: str = "auto",
                     check_flat: bool = False) -> dict:
    """Drive one warm chunk and ``steps`` timed steps of the Engine on the
    Sharded plan over the initialised world (or one rank without a process
    group); returns {steps_per_s, rebuilds, migrated, halo ledger, ...}."""
    import torch

    from repro_torch.configs.fege_spinlattice import config, smoke_config
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.state import init_state
    from repro_torch.parallel.plan import Sharded
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dt = config().dt
    dtype = torch.float64 if check_flat else torch.float32
    lat = simple_cubic()
    g = torch.Generator(device=dev).manual_seed(seed)
    st = init_state(lat, tuple(cells), generator=g, temperature=temperature,
                    spin_init="helix_x", dtype=dtype, device=dev)
    if kernel:   # the smoke spec keeps the orchestration timing cheap
        spec = smoke_config().spec
        potential = NEPSpinPotential(
            spec, init_params(spec, g, dtype=dtype, device=dev),
            use_kernel=True)
    else:
        potential = HeisenbergDMIModel(d0=0.01)
    kw = dict(potential=potential, state=st,
              masses=torch.tensor(lat.masses, dtype=dtype, device=dev),
              magnetic=torch.tensor(lat.moments, device=dev) > 0,
              cutoff=5.0, capacity=16, skin=0.3,
              observables=("energy", "magnetization", "charge"), device=dev)
    if check_flat:
        kw["cfg"] = IntegratorConfig(dt=dt, moment=1.16)
    else:
        t_end = steps * dt
        temp, field = protocol.field_cooling(
            temperature, temperature / 4, 0.1, t_hold=0.2 * t_end,
            t_ramp=0.6 * t_end)
        kw.update(cfg=IntegratorConfig(dt=dt, moment=1.16, lattice_gamma=1.0,
                                       spin_alpha=0.01),
                  temperature=temp, field=field)
    eng = Engine(plan=Sharded(halo_mode=halo_mode), **kw)
    rank = eng._rplan.rank
    run_gen = torch.Generator(device=dev).manual_seed(1 + 1000 * rank)
    eng.run(chunk, run_gen, chunk=chunk)                  # warm
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    eng.run(steps, run_gen, chunk=chunk)
    sync()
    wall = time.perf_counter() - t0
    vs_flat = None
    if check_flat and rank == 0:
        flat = Engine(**kw)
        flat.run(chunk + steps, chunk=chunk)
        vs_flat = max(float((getattr(flat.state, k)
                             - getattr(eng.state, k)).abs().max())
                      for k in ("pos", "vel", "spin"))
    ledger = eng.halo_ledger
    return {
        "ranks": eng._rplan.world, "atoms": int(st.pos.shape[0]),
        "cells": list(eng._rplan.dspec.cells),
        "cell_capacity": int(eng._rplan.dspec.capacity),
        "allgather": eng._rplan.allgather,
        "steps_per_s": steps / wall, "rebuilds": eng.n_rebuilds,
        "migrated": eng.n_migrated, "vs_flat": vs_flat,
        "charge": [float(q) for q in eng.trace.values["charge"]],
        "halo_counts": dict(ledger.counts), "halo_bytes": dict(ledger.bytes),
        "halo_bytes_per_step": ledger.per_step_bytes(),
    }


def _rank_main(rank: int, kw: dict) -> None:
    res = run_engine_chunk(**kw)
    if rank == 0:
        _report(res)


def _report(res: dict) -> None:
    print(f"engine chunk on {res['ranks']} rank(s): {res['atoms']} atoms, "
          f"grid {res['cells']} x {res['cell_capacity']}, "
          f"{res['steps_per_s']:.1f} steps/s, {res['rebuilds']} rebuilds "
          f"({res['migrated']} migrations)")
    print(f"  halo ledger: {res['halo_counts']}")
    print(f"  Q trace: {[round(q, 2) for q in res['charge']]}")
    print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, nargs=3, default=(8, 6, 6))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--kernel", action="store_true",
                    help="NEP-SPIN through K1/K2 and the q_Fp halo")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks to spawn (1: this process, no group)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--halo-mode", default="auto",
                    choices=("auto", "ppermute", "allgather"))
    ap.add_argument("--check-flat", action="store_true",
                    help="f64 NVE, checked on rank 0 against the flat "
                         "Engine")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kw = dict(cells=tuple(args.cells), steps=args.steps, chunk=args.chunk,
              kernel=args.kernel, device=args.device,
              halo_mode=args.halo_mode, check_flat=args.check_flat)
    if args.nproc == 1:
        _report(run_engine_chunk(**kw))
        return 0
    from repro_torch.parallel.ranks import spawn
    spawn(_rank_main, args.nproc, kw, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
