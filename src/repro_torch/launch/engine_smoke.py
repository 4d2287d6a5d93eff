"""Smoke run of the Engine on the Sharded plan over 2 ranks (port of
``scripts/engine_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.engine_smoke [--device cpu]

Two gloo ranks (``parallel/ranks.py:spawn``; on the card both share it,
as ``chip_smoke.py``'s phase J(b) does) drive a simple-cubic 8x6x6 lattice
under ``HeisenbergDMIModel(d0=0.01)`` and the field-cooling schedule
``field_cooling(300, 50, 25, t_hold=0.004, t_ramp=0.02)`` through
``Engine(plan=Sharded())``:

* 20 steps in chunks of 10 with a runlog: ``run_start`` first, ``run_end``
  last with status ``ok``, at least one chunk record; each chunk's
  ``halo`` record holds its chunk's exchanges, and the chunks together
  hold exactly what the engine's run-scoped ledger
  (``engine.halo_ledger.snapshot()``) gained over the run (the port's
  ledger counts each exchange as it runs, where the reference's records
  the compiled chunk's once); each chunk carries ``e_drift`` and a
  verdict of ``ok`` or ``warn``; no kernel library is built or loaded
  after the first chunk (the runlog's ``compiles``, from
  ``_build.EVENTS``); ``python -m repro_torch.launch.report`` renders the
  runlog;
* 10 steps, a checkpoint, a fresh engine restored from it and 10 more
  steps: bitwise the uninterrupted 20 in pos, vel and spin, on each rank;
* the charge trace has shape (2,).

``main`` returns rank 0's summary dict and raises on any failure.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NPROC, STEPS, CHUNK = 2, 20, 10


def make_engine(device):
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.state import init_state
    from repro_torch.parallel.plan import Sharded
    lat = simple_cubic()
    st = init_state(lat, (8, 6, 6), temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator(device=device).manual_seed(0),
                    device=device)
    temp, field = protocol.field_cooling(300.0, 50.0, 25.0, t_hold=0.004,
                                         t_ramp=0.02)
    return Engine(
        potential=HeisenbergDMIModel(d0=0.01),
        cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05, lattice_gamma=1.0),
        state=st, masses=torch.tensor(lat.masses, dtype=torch.float32,
                                      device=device),
        magnetic=torch.tensor(lat.moments, device=device) > 0, cutoff=5.0,
        capacity=16, skin=0.2, plan=Sharded(), temperature=temp,
        field=field, observables=("energy", "magnetization", "charge"),
        device=device)


def check_runlog(path, ledger_gain) -> int:
    """The telemetry contract on rank 0's runlog; returns its chunks."""
    from repro_torch.telemetry import read_runlog
    events = read_runlog(path)
    kinds = [e["event"] for e in events]
    if kinds[0] != "run_start" or kinds[-1] != "run_end":
        raise AssertionError(kinds)
    chunks = [e for e in events if e["event"] == "chunk"]
    if not chunks:
        raise AssertionError("runlog has no chunk records")
    total = {"counts": {}, "bytes": {}}
    for c in chunks:
        for k in total:
            for tag, v in c["halo"][k].items():
                total[k][tag] = total[k].get(tag, 0) + v
        if "e_drift" not in c["health"]:
            raise AssertionError(c["health"])
        if c["verdict"] not in ("ok", "warn"):
            raise AssertionError(c["verdict"])
    drop = {k: {t: v for t, v in total[k].items() if v} for k in total}
    if drop != ledger_gain:
        raise AssertionError(f"runlog halo records diverge from the "
                             f"run-scoped ledger:\n  records: {drop}\n"
                             f"  ledger: {ledger_gain}")
    for c in chunks[1:]:
        if c["compiles"] != 0:
            raise AssertionError(f"chunk {c['chunk']} built or loaded "
                                 f"{c['compiles']} kernel(s)")
    if events[-1]["status"] != "ok":
        raise AssertionError(events[-1])
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.report", path],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": _SRC + os.pathsep
             + os.environ.get("PYTHONPATH", "")})
    if rep.returncode != 0 or "Run report" not in rep.stdout:
        raise AssertionError(f"report failed:\n{rep.stdout}\n{rep.stderr}")
    return len(chunks)


def _gain(after: dict, before: dict) -> dict:
    return {k: {t: v - before[k].get(t, 0) for t, v in after[k].items()
                if v - before[k].get(t, 0)} for k in ("counts", "bytes")}


def _rank(rank: int, device: str, workdir: str, out: str) -> None:
    """One rank of the smoke (every rank runs every engine: building one
    on the Sharded plan is a collective of the whole world)."""
    dev = torch.device(device)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)  # noqa: E731
    a = make_engine(dev)
    before = a.halo_ledger.snapshot()
    runlog = os.path.join(workdir, "smoke.jsonl")
    a.run(STEPS, gen(), chunk=CHUNK, telemetry=runlog)
    gain = _gain(a.halo_ledger.snapshot(), before)
    n_chunks = check_runlog(runlog, gain) if rank == 0 else None
    ckpt = os.path.join(workdir, "ckpt")
    b = make_engine(dev)
    b.run(CHUNK, gen(), chunk=CHUNK, checkpoint_dir=ckpt)
    c = make_engine(dev)
    resume = c.restore(ckpt)
    c.run(STEPS - CHUNK, resume, chunk=CHUNK)
    for name in ("pos", "vel", "spin"):
        if not torch.equal(getattr(a.state, name), getattr(c.state, name)):
            raise AssertionError(f"rank {rank}: {name} not bitwise after "
                                 "resume")
    charge = a.trace.values["charge"]
    if tuple(charge.shape) != (2,):
        raise AssertionError(f"charge trace {tuple(charge.shape)}")
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"ranks": a._rplan.world, "chunks": n_chunks,
                       "halo": gain, "resume_bitwise": True,
                       "charge": [float(q) for q in charge]}, f)


def main(argv=None) -> dict:
    from repro_torch.parallel.ranks import spawn
    from repro_torch.utils.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "result.json")
        spawn(_rank, NPROC, str(dev), d, out, backend="gloo", workdir=d)
        with open(out) as f:
            res = json.load(f)
    print(f"[engine_smoke] {res['ranks']} gloo ranks on {dev.type}: "
          f"{res['chunks']} chunk records vs the halo ledger, report "
          f"rendered; checkpoint/resume bitwise; Q trace {res['charge']}")
    print(json.dumps({"engine_smoke": res}))
    return res


if __name__ == "__main__":
    main()
