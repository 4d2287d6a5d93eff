"""CLI front-end for the simulation job server (port of
``repro.launch.serve``).

Builds a synthetic multi-tenant fleet of heterogeneous (T, B)-protocol
jobs - mixed step budgets, two geometries (two shape buckets), constant
holds, linear anneals, and field protocols - submits them through
admission control, drains the server, and prints per-job statuses plus
the per-tenant accounting replayed from the runlog:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --jobs 12 --slots 4 \\
        --runlog runs/serve.jsonl --report

The default fleet is the reference's (Heisenberg-DMI on simple cubic
4x4x4 and 6x4x4 cells).  ``--potential nepspin`` serves NEP-SPIN jobs
(:func:`build_nep_fleet`) through K1/K2 instead - on the card one K1 and
one K2 launch per step for all slots of a bucket: the production spec
on B20 16^3 and 32^3 cells (32,768 and 262,144 atoms, the fleet
``chip_smoke.py`` serves), or under ``--smoke`` the smoke spec on 2x2x2
and 3x2x2 cells:

    PYTHONPATH=src python -m repro_torch.launch.serve --potential nepspin \
        --jobs 12 --slots 4 --chunk 20 --obs-every 10

``--threaded`` exercises the background worker (submit-then-wait)
instead of the synchronous ``drain()``.  ``--report`` renders the runlog
through ``launch/report.py`` afterwards.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.ensemble import protocol
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import b20_fege, simple_cubic
from repro_torch.md.state import init_state
from repro_torch.serve import ServeConfig, SimJob, SimServer
from repro_torch.utils.device import resolve_device


def build_fleet(n_jobs: int, chunk: int, obs_every: int,
                dt: float = 2e-3, *, device="cuda",
                dtype=torch.float32) -> list[SimJob]:
    """A deterministic synthetic job mix: two geometries, two tenants,
    four protocol shapes, step budgets cycling over 2/3/4 chunks."""
    dev = resolve_device(device)
    lat = simple_cubic()
    # frozen_lattice: the server admits spin-dynamics jobs only (packed
    # slots share one neighbor table - see serve.validate_job)
    cfg = IntegratorConfig(dt=dt, spin_alpha=0.05, frozen_lattice=True,
                           temperature=100.0)
    geoms = [(4, 4, 4), (6, 4, 4)]
    tenants = ["alice", "bob"]
    jobs = []
    for i in range(n_jobs):
        n_cells = geoms[i % len(geoms)]
        steps = chunk * (2 + i % 3)
        if i % 4 == 0:
            temp, field = 100.0, None                      # plain hold
        elif i % 4 == 1:
            temp = protocol.linear(0.0, steps * dt, 300.0, 50.0)
            field = None                                   # anneal
        elif i % 4 == 2:
            temp, field = 100.0, np.asarray([0.0, 0.0, 5.0])
        else:
            temp, field = protocol.field_cooling(
                300.0, 50.0, 10.0, t_hold=chunk * dt,
                t_ramp=chunk * dt)                         # Fig. 9 shape
        state = init_state(
            lat, n_cells, temperature=100.0, spin_init="helix_x",
            generator=torch.Generator(device=dev).manual_seed(100 + i),
            dtype=dtype, device=dev)
        jobs.append(SimJob(
            state=state, potential=HeisenbergDMIModel(d0=0.01), cfg=cfg,
            masses=np.asarray(lat.masses),
            magnetic=np.asarray(lat.moments) > 0,
            steps=steps, temperature=temp, field=field,
            obs_every=obs_every, seed=100 + i,
            tenant=tenants[i % len(tenants)],
            name=f"fleet-{i:02d}"))
    return jobs


NEP_BUDGETS = (40, 60, 80)      # steps, cycled over the jobs of a bucket
NEP_CELLS = ((16, 16, 16), (32, 32, 32))   # B20 unit cells of the buckets
NEP_SMOKE_CELLS = ((2, 2, 2), (3, 2, 2))
NEP_SEED = 31                   # the random weights' seed


def nep_potential(spec, seed: int, *, device="cuda", dtype=torch.float32):
    """NEP-SPIN with random weights from ``seed`` on the kernel path."""
    from repro_torch.core.potential import NEPSpinPotential, init_params
    dev = resolve_device(device)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(seed),
                         dtype=dtype, device=dev)
    return NEPSpinPotential(spec, params,
                            torch.tensor([1.16, 0.0], dtype=dtype,
                                         device=dev), use_kernel=True)


def build_nep_fleet(potential, geometries, jobs_per_geometry: int,
                    obs_every: int, budgets=NEP_BUDGETS) -> list[SimJob]:
    """NEP-SPIN jobs on B20 FeGe, ``jobs_per_geometry`` per entry of
    ``geometries`` (unit cells), on the device and in the dtype of the
    potential's weights: budgets cycling over ``budgets``, and protocols
    cycling over a 300 K hold, a 300 -> 100 K anneal over the job, a 0.2 T
    field along z at 300 K, and field cooling (300 -> 100 K in 0.2 T, a
    hold and a ramp of a quarter of the job each).  Spins start as a helix
    along x; the lattice is frozen (serving); the step, damping, table
    capacity and skin are the main path's (``configs.fege_spinlattice``)."""
    from repro_torch.configs.fege_spinlattice import main_path
    run = main_path()
    dev, dtype = potential.params.w1.device, potential.params.w1.dtype
    lat = b20_fege()
    dt = run.dt
    cfg = IntegratorConfig(dt=dt, spin_alpha=run.spin_alpha,
                           frozen_lattice=True, temperature=300.0)
    seed = 200
    jobs = []
    for g, cells in enumerate(geometries):
        for j in range(jobs_per_geometry):
            i = g * jobs_per_geometry + j
            steps = budgets[j % len(budgets)]
            span = steps * dt
            temp, field = 300.0, None                      # hold
            if j % 4 == 1:
                temp = protocol.linear(0.0, span, 300.0, 100.0)   # anneal
            elif j % 4 == 2:
                field = np.asarray([0.0, 0.0, 0.2])        # field
            elif j % 4 == 3:
                temp, field = protocol.field_cooling(
                    300.0, 100.0, 0.2, t_hold=span / 4, t_ramp=span / 4)
            state = init_state(
                lat, cells, spin_init="helix_x", dtype=dtype, device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed + i))
            jobs.append(SimJob(
                state=state, potential=potential, cfg=cfg,
                masses=np.asarray(lat.masses),
                magnetic=np.asarray(lat.moments) > 0, steps=steps,
                cutoff=potential.spec.cutoff, capacity=run.capacity,
                skin=run.skin,
                temperature=temp, field=field, obs_every=obs_every,
                seed=seed + i, tenant=("alice", "bob", "carol")[i % 3],
                name=f"nep-{'x'.join(map(str, cells))}-{j:02d}"))
    return jobs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=8,
                    help="fleet size (default 8)")
    ap.add_argument("--slots", type=int, default=2,
                    help="replica slots per packed batch")
    ap.add_argument("--chunk", type=int, default=10,
                    help="segment length in steps")
    ap.add_argument("--obs-every", type=int, default=5,
                    help="observable cadence in steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--potential", choices=("heisenberg", "nepspin"),
                    default="heisenberg",
                    help="Heisenberg-DMI jobs (the reference's fleet) or "
                         "NEP-SPIN jobs through K1/K2 (random weights)")
    ap.add_argument("--runlog", default=None,
                    help="runlog path (default: workdir/serve.jsonl)")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint/working dir (default: temp dir)")
    ap.add_argument("--journal", default=None, metavar="DIR",
                    help="enable the durable job journal (WAL) in DIR")
    ap.add_argument("--recover", action="store_true",
                    help="replay the journal instead of starting fresh "
                         "(requires --journal; resubmits the same fleet, "
                         "completed jobs deduplicate, interrupted jobs "
                         "resume from their committed watermark)")
    ap.add_argument("--threaded", action="store_true",
                    help="background worker + wait() instead of drain()")
    ap.add_argument("--report", action="store_true",
                    help="render the runlog report afterwards")
    ap.add_argument("--smoke", action="store_true",
                    help="small fast fleet (6 jobs, tiny geometries)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.jobs = min(args.jobs, 6)
    workdir = args.workdir or tempfile.mkdtemp(prefix="simserve-")
    runlog = args.runlog or os.path.join(workdir, "serve.jsonl")
    cfg = ServeConfig(runlog=runlog, workdir=workdir, slots=args.slots,
                      chunk=args.chunk, journal_dir=args.journal)
    if args.recover:
        if not args.journal:
            ap.error("--recover requires --journal DIR")
        server = SimServer.recover(cfg)
    else:
        server = SimServer(cfg)
    if args.potential == "nepspin":
        from repro_torch.configs.fege_spinlattice import config, smoke_config
        spec = (smoke_config() if args.smoke else config()).spec
        cells = NEP_SMOKE_CELLS if args.smoke else NEP_CELLS
        fleet = build_nep_fleet(
            nep_potential(spec, NEP_SEED, device=args.device), cells,
            args.jobs // len(cells), args.obs_every,
            budgets=tuple(args.chunk * k for k in (2, 3, 4)))
    else:
        fleet = build_fleet(args.jobs, args.chunk, args.obs_every,
                            device=args.device)
    print(f"submitting {len(fleet)} jobs "
          f"({args.slots} slots, chunk {args.chunk}) -> {runlog}")
    handles = [server.submit(job) for job in fleet]
    n_buckets = len({h.bucket for h in handles if h.bucket is not None})
    print(f"{n_buckets} shape bucket(s)")

    if args.threaded:
        server.start()
        for h in handles:
            h.wait(timeout=600)
        server.stop()
    else:
        server.drain()

    for h in handles:
        tail = (f"{h.rows_streamed} rows"
                if h.status == "done" else (h.error or "")[:48])
        if h.recovered and h.rows_streamed == 0:
            tail = "deduplicated"     # journal match: no bucket, no rows
        bucket = h.bucket.id if h.bucket is not None else "-"
        print(f"  {h.id} [{h.job.name}] tenant={h.tenant} "
              f"bucket={bucket} steps={h.job.steps}: "
              f"{h.status} ({tail})")

    acct = server.accounting
    print("accounting consistent:", acct.consistent())
    for tenant, t in sorted(acct.tenants.items()):
        print(f"  {tenant}: {t['jobs_done']}/{t['jobs_submitted']} done, "
              f"{t['charged_steps']} slot-steps charged "
              f"({t['wall_s']:.2f}s wall share)")
    for bid, b in sorted(acct.buckets.items()):
        print(f"  bucket {bid}: {b['chunks']} chunks, "
              f"{b['warmup_compiles']} warmup / "
              f"{b['steady_compiles']} steady builds and loads")

    if args.report:
        from repro_torch.launch.report import runlog_report
        print()
        print(runlog_report(runlog))
    bad = [h for h in handles if h.status != "done"]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
