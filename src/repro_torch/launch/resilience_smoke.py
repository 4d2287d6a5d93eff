"""Smoke run of supervised fault recovery and kill-and-resume (port of
``scripts/resilience_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.resilience_smoke [--device cpu]

Two end-to-end recovery paths on the flat plan (simple cubic 4x4x4,
Heisenberg-DMI, 300 K, 4 chunks x 10 steps):

1. supervised retry: a seeded NaN fault is injected into the forces at
   step 25, the health gate raises, the supervisor rolls back to the
   newest checkpoint and retries.  The recovered trajectory must be
   BITWISE the uninterrupted run's, no kernel may be built or loaded after
   the rollback (0 in every runlog chunk record after it), and the runlog
   must hold the fault_injected / rollback / retry / recovered records,
   which ``python -m repro_torch.launch.report`` renders;
2. kill-and-resume: a crash fault SIGKILLs a child run at step 25; the
   parent checks the kill, restores the newest checkpoint (at most one
   chunk of work lost) and runs to the end, bitwise the uninterrupted run.

Exits nonzero on any failure.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile

import torch

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS, CHUNK, FAULT_STEP = 40, 10, 25


def make_engine(device, potential=None):
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.state import init_state
    lat = simple_cubic()
    st = init_state(lat, (4, 4, 4), temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator(device=device).manual_seed(3),
                    device=device)
    return Engine(potential=potential or HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=st, masses=torch.tensor(lat.masses,
                                                dtype=torch.float32,
                                                device=device),
                  magnetic=torch.tensor(lat.moments, device=device) > 0,
                  cutoff=5.0, capacity=8, skin=0.2,
                  observables=("energy", "magnetization"), device=device)


def generator(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def assert_bitwise(a, b, what):
    for leaf in ("pos", "vel", "spin"):
        x, y = getattr(a, leaf), getattr(b, leaf)
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {leaf} differs (max "
                                 f"{float((x - y).abs().max()):.3e})")


def _env():
    return {**os.environ, "PYTHONPATH": _SRC + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def supervised_retry(device, tmp) -> dict:
    from repro_torch.resilience import (Fault, FaultPlan, Supervisor,
                                        SupervisorConfig, install_faults)
    from repro_torch.telemetry import HealthConfig, Telemetry, read_runlog
    ref = make_engine(device)
    ref.run(STEPS, generator(device), chunk=CHUNK)
    log = os.path.join(tmp, "run.jsonl")
    eng = make_engine(device)
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=FAULT_STEP, leaf="force"),)), runlog=log)
    sup = Supervisor(SupervisorConfig(max_retries=2))
    out = sup.run(eng, STEPS, generator(device), chunk=CHUNK,
                  checkpoint_dir=os.path.join(tmp, "ck"),
                  telemetry=Telemetry(runlog=log, health=HealthConfig()))
    events = [e["event"] for e in sup.events]
    if events != ["rollback", "retry", "recovered"]:
        raise AssertionError(f"supervisor events {events}")
    assert_bitwise(ref.state, out, "supervised retry")
    records = read_runlog(log)
    logged = [r["event"] for r in records]
    for ev in ("fault_injected", "rollback", "retry", "recovered"):
        if ev not in logged:
            raise AssertionError(f"runlog lacks {ev}: {logged}")
    first_rb = next(i for i, r in enumerate(records)
                    if r["event"] == "rollback")
    retry_compiles = [r["compiles"] for r in records[first_rb:]
                      if r["event"] == "chunk"]
    if not retry_compiles or any(retry_compiles):
        raise AssertionError(f"builds after the rollback: {retry_compiles}")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                        log], capture_output=True, text=True, env=_env())
    if (r.returncode != 0 or "rollback" not in r.stdout
            or "recovered" not in r.stdout):
        raise AssertionError(f"report: {r.returncode} {r.stdout[-2000:]} "
                             f"{r.stderr[-2000:]}")
    print(f"[resilience_smoke] supervised retry OK (bitwise, builds after "
          f"the rollback {retry_compiles})")
    return {"events": events, "retry_compiles": retry_compiles,
            "report": r.stdout}


def kill_and_resume(device, tmp) -> dict:
    from repro_torch.ckpt.checkpoint import latest_step
    ref = make_engine(device)
    ref.run(STEPS, generator(device), chunk=CHUNK)
    ck = os.path.join(tmp, "ck_crash")
    child = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.resilience_smoke",
         "--crash-child", ck, "--device", str(device)],
        capture_output=True, text=True, env=_env())
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"crash child exited {child.returncode}: "
                             f"{child.stderr[-2000:]}")
    last = latest_step(ck)
    if last is None or STEPS - last > 2 * CHUNK:
        raise AssertionError(f"more than one chunk lost (newest checkpoint "
                             f"{last})")
    eng = make_engine(device)
    gen = eng.restore(ck)
    eng.run(STEPS - eng._step_now(), gen, chunk=CHUNK)
    assert_bitwise(ref.state, eng.state, "kill-and-resume")
    print(f"[resilience_smoke] kill-and-resume OK (killed run checkpointed "
          f"through step {last}, bitwise)")
    return {"latest": last, "child_rc": child.returncode}


def crash_child(ck, device):
    from repro_torch.resilience import Fault, FaultPlan, install_faults
    eng = make_engine(device)
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="crash", step=FAULT_STEP),)))
    eng.run(STEPS, generator(device), chunk=CHUNK, checkpoint_dir=ck,
            checkpoint_every=1)
    raise SystemExit("the crash fault did not fire")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crash-child", default=None)
    args = ap.parse_args(argv)
    from repro_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    if args.crash_child:
        crash_child(args.crash_child, device)
    tmp = tempfile.mkdtemp(prefix="resilience_smoke_")
    out = {"supervised": supervised_retry(device, tmp),
           "kill_resume": kill_and_resume(device, tmp)}
    print(json.dumps({"resilience_smoke": {
        "events": out["supervised"]["events"],
        "retry_compiles": out["supervised"]["retry_compiles"],
        "latest_checkpoint": out["kill_resume"]["latest"]}}))
    return out


if __name__ == "__main__":
    main()
