"""The serving tier under chaos - journal recovery after SIGKILL, at f64
(port of ``scripts/serve_chaos_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_chaos_smoke [--device cpu]

A child process serves a deterministic fleet (4 jobs of
``repro_torch.launch.serve.build_fleet``, 2 slots, chunk 10) with a
seeded :class:`~repro_torch.resilience.faults.FaultPlan` installed on
every bucket engine:

* a transient NaN and a spin bit flip mid-flight - the supervisor's
  rollback and the serving rung (evict the blamed slot, requeue the job
  once) absorb both inside the child;
* a ``crash`` fault that SIGKILLs the child mid-fleet.

The parent checks the kill, rebuilds the server with
``SimServer.recover`` from the durable job journal, resubmits the SAME
fleet, and drains.  Acceptance:

* completed jobs deduplicate (no recomputation, no double charge);
* every surviving job's remaining observable stream and final state are
  BITWISE identical (f64) to an uninterrupted reference fleet - the
  interrupted job resumes from its committed watermark;
* no kernel library built or loaded after a bucket's first chunk, across
  BOTH incarnations (``steady_compiles == 0``);
* the per-tenant accounting invariant (charged + idle == computed
  slot-steps) closes exactly over the combined runlog;
* the report CLI renders both the serving runlog and the journal.

Exits nonzero on any failure; ``main`` returns a summary dict.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

import numpy as np
import torch

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_JOBS = 4
CHUNK = 10
OBS_EVERY = 5


def _chaos():
    from repro_torch.resilience import Fault, FaultPlan
    return FaultPlan(faults=(
        Fault(kind="nan", step=12, leaf="force"),
        Fault(kind="bit_flip", step=22, leaf="spin", bit=62),
        Fault(kind="crash", step=35),
    ), seed=7)


def _fleet(device):
    from repro_torch.launch.serve import build_fleet
    return build_fleet(N_JOBS, CHUNK, OBS_EVERY, device=device,
                       dtype=torch.float64)


def serve_cfg(tmp, *, faults=None):
    from repro_torch.serve import RequeuePolicy, ServeConfig
    return ServeConfig(
        runlog=os.path.join(tmp, "chaos.jsonl"),
        workdir=os.path.join(tmp, "chaos"),
        journal_dir=os.path.join(tmp, "journal"),
        slots=2, chunk=CHUNK,
        requeue=RequeuePolicy(retries=1, backoff_s=0.0),
        faults=faults)


def _env():
    return {**os.environ, "PYTHONPATH": _SRC + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def child_main(tmp, device) -> None:
    from repro_torch.serve import SimServer
    srv = SimServer(serve_cfg(tmp, faults=_chaos()))
    for job in _fleet(device):
        srv.submit(job)
    srv.drain()
    raise SystemExit("crash fault did not fire")


def report(path) -> str:
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", str(path)],
        capture_output=True, text=True, env=_env())
    if r.returncode != 0:
        raise AssertionError(r.stderr[-2000:])
    return r.stdout


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from repro_torch.serve import ServeConfig, SimServer
    from repro_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    if args.child:
        child_main(args.child, device)
    tmp = tempfile.mkdtemp(prefix="serve-chaos-")

    # uninterrupted reference fleet (same packed shape, no faults)
    ref_srv = SimServer(ServeConfig(runlog=os.path.join(tmp, "ref.jsonl"),
                                    workdir=os.path.join(tmp, "ref"),
                                    slots=2, chunk=CHUNK))
    refs = [ref_srv.submit(job) for job in _fleet(device)]
    ref_srv.drain()
    for g in refs:
        if g.status != "done":
            raise AssertionError((g.id, g.status, g.error))

    # --- child: serve the fleet into the chaos plan, die by SIGKILL ---
    child = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_chaos_smoke",
         "--child", tmp, "--device", str(device)],
        capture_output=True, text=True, env=_env())
    if child.returncode != -signal.SIGKILL:
        raise AssertionError((child.returncode, child.stderr[-2000:]))
    print("[serve_chaos_smoke] child SIGKILLed mid-fleet as planned")

    # --- parent: journal recovery + idempotent resubmission -----------
    srv = SimServer.recover(serve_cfg(tmp))    # no faults this time
    handles = [srv.submit(job) for job in _fleet(device)]
    deduped = [h for h in handles if h.status == "done"]
    resumed = [h for h in handles if h.rows_base > 0]
    if not deduped:
        raise AssertionError("no job deduplicated against the journal")
    if not resumed:
        raise AssertionError("no job resumed from a committed watermark")
    print(f"[serve_chaos_smoke] recovered: {len(deduped)} deduplicated, "
          f"{len(resumed)} resumed from watermark, "
          f"{len(handles) - len(deduped) - len(resumed)} requeued")
    srv.drain()

    # bitwise recovery replay: remaining streams + final states (f64)
    for h, g in zip(handles, refs):
        if h.status != "done":
            raise AssertionError((h.id, h.status, h.error))
        if h.rows_streamed:
            for name, rows in g.observables.items():
                if not np.array_equal(h.observables[name],
                                      rows[h.rows_base:]):
                    raise AssertionError(f"{h.id} {name} diverges from the "
                                         "uninterrupted run")
        if h.final_state is not None:
            for leaf in ("pos", "vel", "spin"):
                if not torch.equal(getattr(h.final_state, leaf),
                                   getattr(g.final_state, leaf)):
                    raise AssertionError(f"{h.id} final {leaf} diverges")
    if not any(h.final_state is not None for h in resumed):
        raise AssertionError("no resumed job reached a comparable final "
                             "state")
    print("[serve_chaos_smoke] remaining streams + final states bitwise vs "
          "the uninterrupted fleet (f64)")

    acct = srv.accounting
    if acct.recoveries != 1:
        raise AssertionError(acct.summary())
    for bid, b in sorted(acct.buckets.items()):
        if b["steady_compiles"] != 0:
            raise AssertionError(f"bucket {bid} built or loaded a kernel "
                                 f"after its first chunk: {b}")
    if not acct.consistent():
        raise AssertionError(acct.summary())
    for tenant, t in sorted(acct.tenants.items()):
        print(f"[serve_chaos_smoke] tenant {tenant}: "
              f"{t['charged_steps']} slot-steps charged")

    out = report(serve_cfg(tmp).runlog)
    if "Per-tenant" not in out:
        raise AssertionError(out)
    jout = report(os.path.join(tmp, "journal", "journal.jsonl"))
    if "commit" not in jout or "recovered" not in jout:
        raise AssertionError(jout)
    print("[serve_chaos_smoke] reports render runlog + journal OK")
    summary = {"child_rc": child.returncode, "deduplicated": len(deduped),
               "resumed": len(resumed),
               "requeued": len(handles) - len(deduped) - len(resumed),
               "evictions": len(acct.evictions),
               "requeues": len(acct.requeues),
               "consistent": True}
    print(json.dumps({"serve_chaos_smoke": summary}))
    return summary


if __name__ == "__main__":
    main()
