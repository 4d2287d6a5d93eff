#!/usr/bin/env python3
"""Serving-tier rates: packed drain, journal overhead, recovery replay
(port of ``benchmarks/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_rate [--smoke]
        [--device cuda|cpu] [--out DIR]

Through ``launch/serve.py:build_fleet`` (two geometries, two tenants, four
protocol shapes; 8 jobs, 4 under ``--smoke``) and
:class:`~repro_torch.serve.SimServer` (2 slots, chunk 10, observables every
5), after one throwaway drain:

* ``serve/drain``: submit + drain; jobs/s, slot-steps/s and the builds
  split into warmup and steady from the accounting ledger;
* ``serve/journal``: the same fleet with the job journal (WAL) on; the
  derived column is its overhead in % of the plain drain;
* ``serve/recover``: a journaled fleet abandoned after two scheduler ticks,
  :meth:`SimServer.recover` and the fleet resubmitted (completed jobs
  deduplicate, interrupted ones resume from their watermark): the replay +
  resubmit seconds, then the drain that must finish every job.

Every job must end ``done`` with a consistent ledger; full runs also demand
0 steady builds in both the plain drain and the recovered one.  The
servers' run logs and journals go under ``--out``/``serve_rate/`` and the
result to ``serve_rate.json``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import time

from repro_torch.launch import bench_common as bc

CHUNK = 10
OBS_EVERY = 5
SLOTS = 2


def n_jobs() -> int:
    return 4 if bc.smoke() else 8


def _cfg(root: str, name: str, *, journal: bool = False):
    from repro_torch.serve import ServeConfig
    return ServeConfig(
        runlog=os.path.join(root, f"{name}.jsonl"),
        workdir=os.path.join(root, name),
        journal_dir=os.path.join(root, f"{name}-journal") if journal
        else None,
        slots=SLOTS, chunk=CHUNK)


def _fleet(dev):
    from repro_torch.launch.serve import build_fleet
    return build_fleet(n_jobs(), CHUNK, OBS_EVERY, device=dev)


def _all_done(handles) -> None:
    bad = [(h.id, h.status, h.error) for h in handles if h.status != "done"]
    if bad:
        raise AssertionError(f"jobs not done: {bad}")


def _consistent(acct) -> None:
    if not acct.consistent():
        raise AssertionError(f"accounting does not close: {acct.summary()}")


def _drain(cfg, dev) -> tuple[float, object]:
    """(submit + drain wall s, drained server)."""
    from repro_torch.serve import SimServer
    srv = SimServer(cfg)
    jobs = _fleet(dev)
    bc.sync(dev)
    t0 = time.perf_counter()
    handles = [srv.submit(job) for job in jobs]
    srv.drain()
    bc.sync(dev)
    wall = time.perf_counter() - t0
    _all_done(handles)
    return wall, srv


def _builds(acct) -> tuple[int, int]:
    warm = sum(b["warmup_compiles"] for b in acct.buckets.values())
    steady = sum(b["steady_compiles"] for b in acct.buckets.values())
    return warm, steady


def run(device="cuda", out_dir=bc.OUT_DIR) -> dict:
    from repro_torch.serve import SimServer
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    smoke, jobs = bc.smoke(), n_jobs()
    root = os.path.join(str(out_dir), "serve_rate")
    shutil.rmtree(root, ignore_errors=True)
    total_steps = sum(j.steps for j in _fleet(dev))
    out = {"smoke": smoke, "device": str(dev), "n_jobs": jobs,
           "slots": SLOTS, "chunk": CHUNK, "total_slot_steps": total_steps}
    rows = []
    _drain(_cfg(root, "warmup"), dev)      # first builds and loads

    wall, srv = _drain(_cfg(root, "plain"), dev)
    acct = srv.accounting
    _consistent(acct)
    warm, steady = _builds(acct)
    out["drain"] = {"wall_s": wall, "jobs_per_s": jobs / wall,
                    "slot_steps_per_s": total_steps / wall,
                    "warmup_compiles": warm, "steady_compiles": steady}
    rows.append(bc.row(
        f"serve/drain/J={jobs}", wall * 1e6 / jobs,
        f"{jobs / wall:.2f} jobs/s|{total_steps / wall:.3e} slot-step/s|"
        f"{warm} warmup/{steady} steady builds"))

    wall_j, srv_j = _drain(_cfg(root, "wal", journal=True), dev)
    _consistent(srv_j.accounting)
    overhead = (wall_j / wall - 1.0) * 100.0
    out["journal"] = {"wall_s": wall_j, "overhead_pct": overhead}
    rows.append(bc.row(f"serve/journal/J={jobs}", wall_j * 1e6 / jobs,
                       f"journal overhead {overhead:+.1f}% vs plain drain"))

    cfg_r = _cfg(root, "rec", journal=True)
    srv_r = SimServer(cfg_r)
    for job in _fleet(dev):
        srv_r.submit(job)
    for _ in range(2):          # two committed chunks a bucket, then die
        srv_r._tick()
    del srv_r
    jobs_again = _fleet(dev)
    t0 = time.perf_counter()
    srv2 = SimServer.recover(cfg_r)
    handles = [srv2.submit(job) for job in jobs_again]
    replay = time.perf_counter() - t0
    deduped = sum(h.status == "done" for h in handles)
    resumed = sum(h.rows_base > 0 for h in handles)
    srv2.drain()
    bc.sync(dev)
    _all_done(handles)
    _consistent(srv2.accounting)
    _, steady2 = _builds(srv2.accounting)
    out["recovery"] = {"replay_s": replay, "deduplicated": deduped,
                       "resumed": resumed, "steady_compiles": steady2}
    rows.append(bc.row(f"serve/recover/J={jobs}", replay * 1e6,
                       f"{deduped} dedup|{resumed} resumed|{steady2} steady "
                       "builds after recovery"))
    if not smoke and (steady or steady2):
        raise AssertionError(f"steady-state builds: drain {steady}, after "
                             f"recovery {steady2}")
    out["rows"] = rows
    return out


def main(argv=None) -> dict:
    ap = bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    args = bc.parse(ap, argv)
    with bc.switches(args):
        out = run(args.device, args.out)
    bc.write_json(args.out / "serve_rate.json", out)
    return out


if __name__ == "__main__":
    main()
