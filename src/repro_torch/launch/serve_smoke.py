"""Serving smoke at f64 (port of ``scripts/serve_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_smoke [--device cpu]

Drives the batched job server (:mod:`repro_torch.serve`) end to end:

* 6 mixed-size jobs across 2 shape buckets (the two geometries of
  ``repro_torch.launch.serve.build_fleet``), heterogeneous (T, B)
  protocols, through a packed 2-slot server and a solo 1-slot server;
* no kernel library built or loaded after a bucket's first chunk
  (``steady_compiles == 0`` from the runlog's build watchdog, read by the
  accounting replay; the watchdog counts builds and loads once per
  process, so a bucket's warmup may read 0 - the reference's
  ``warmup_compiles >= 1`` is a fact of XLA's compile cache);
* every packed job's streamed observables and final state BITWISE equal
  to the same job through the solo server - at f64, where a one-ulp
  difference cannot hide behind f32 noise;
* per-tenant accounting consistent with the engine's chunk records
  (charged + idle slot-steps == computed slot-steps).

Exits nonzero on any failure; ``main`` returns a summary dict.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

N_JOBS = 6
CHUNK = 10
OBS_EVERY = 5


def run_server(tmp, name, slots, device):
    from repro_torch.launch.serve import build_fleet
    from repro_torch.serve import ServeConfig, SimServer
    cfg = ServeConfig(runlog=f"{tmp}/{name}.jsonl", workdir=f"{tmp}/{name}",
                      slots=slots, chunk=CHUNK)
    server = SimServer(cfg)
    handles = [server.submit(job)
               for job in build_fleet(N_JOBS, CHUNK, OBS_EVERY,
                                      device=device, dtype=torch.float64)]
    server.drain()
    return server, handles


def same_job(h, g, what: str = "packed vs solo", skip_rows: int = 0) -> None:
    """Raise unless handle ``h``'s stream and times (from row
    ``skip_rows`` of ``g``'s) and its final state are bitwise ``g``'s."""
    for name, rows in g.observables.items():
        if not np.array_equal(h.observables[name], rows[skip_rows:]):
            raise AssertionError(f"{what}: {h.job.name} {name} differs")
    if not np.array_equal(h.times, g.times[skip_rows:]):
        raise AssertionError(f"{what}: {h.job.name} times differ")
    for leaf in ("pos", "vel", "spin"):
        if not torch.equal(getattr(h.final_state, leaf),
                           getattr(g.final_state, leaf)):
            raise AssertionError(f"{what}: {h.job.name} final {leaf} "
                                 "differs")
    if h.final_state.step != g.final_state.step:
        raise AssertionError(f"{what}: {h.job.name} final step differs")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="serve-smoke-")
    packed, ph = run_server(tmp, "packed", 2, device)
    _, sh = run_server(tmp, "solo", 1, device)

    for h in ph + sh:
        if h.status != "done":
            raise AssertionError(f"{h.id}: {h.status} ({h.error})")
    buckets = {h.bucket for h in ph}
    if len(buckets) < 2:
        raise AssertionError(f"expected >= 2 shape buckets, got {buckets}")
    if ph[0].final_state.spin.dtype != torch.float64:
        raise AssertionError(ph[0].final_state.spin.dtype)
    print(f"[serve_smoke] {len(ph)} jobs done across {len(buckets)} buckets")

    acct = packed.accounting
    for bid, b in sorted(acct.buckets.items()):
        if b["steady_compiles"] != 0:
            raise AssertionError(f"bucket {bid} built or loaded a kernel "
                                 f"after its first chunk: {b}")
        print(f"[serve_smoke] bucket {bid}: {b['chunks']} chunks, "
              f"{b['warmup_compiles']} warmup / 0 steady builds and loads")

    for h, g in zip(ph, sh):
        same_job(h, g)
    print("[serve_smoke] packed-vs-solo bitwise: OK (f64)")

    if not acct.consistent():
        raise AssertionError(acct.summary())
    for tenant, t in sorted(acct.tenants.items()):
        if t["jobs_done"] != t["jobs_submitted"]:
            raise AssertionError((tenant, t))
        print(f"[serve_smoke] tenant {tenant}: {t['jobs_done']} jobs, "
              f"{t['charged_steps']} slot-steps charged")
    out = {"jobs": len(ph), "buckets": len(buckets),
           "chunks": {b: v["chunks"] for b, v in acct.buckets.items()},
           "warmup_compiles": sum(v["warmup_compiles"]
                                  for v in acct.buckets.values()),
           "steady_compiles": 0, "consistent": True,
           "charged_steps": acct.charged_steps,
           "idle_steps": acct.idle_steps}
    print(json.dumps({"serve_smoke": out}))
    return out


if __name__ == "__main__":
    main()
