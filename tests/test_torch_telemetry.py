"""The port's telemetry (ports of ``tests/test_telemetry.py``'s flat-plan
tests): a schedule that goes NaN mid-run raises a structured
``HealthError`` naming the last-good checkpoint, from which a clean engine
resumes; a clean run passes tight thresholds; a violated threshold is
structured; the runlog's ``run_start`` / ``chunk`` / ``run_end`` schema
holds and ``read_runlog`` / ``repair_tail`` handle a torn line; a bad
telemetry argument is rejected; the compile watchdog reads 0 after the
first chunk; a profile directory receives a Chrome trace, and a profiler
that cannot start fails the run.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from repro_torch import _build
from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.ensemble import protocol
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.simulate import Simulation
from repro_torch.md.state import init_state
from repro_torch.telemetry import (CompileWatchdog, HealthConfig,
                                   HealthError, Telemetry, append_event,
                                   read_runlog, repair_tail)
from torch_one_thread import one_torch_thread  # noqa: F401


def _state(seed=3):
    return init_state(simple_cubic(), (4, 4, 4), generator=torch.Generator()
                      .manual_seed(seed), temperature=300.0,
                      spin_init="helix_x", dtype=torch.float64, device="cpu")


def _engine(potential=None, temperature=None, field=None, seed=3):
    lat = simple_cubic()
    return Engine(potential=potential or HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=_state(seed),
                  masses=torch.tensor(lat.masses, dtype=torch.float64),
                  magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                  capacity=8, skin=0.2, temperature=temperature,
                  field=field, observables=("energy", "magnetization"),
                  device="cpu")


def _nan_after(t_nan=0.021, hold=(0.0, 0.0, 5.0)):
    """Field schedule that goes NaN strictly after ``t_nan`` [ps]."""
    nan3 = [float("nan")] * 3
    return protocol.piecewise([0.0, t_nan, t_nan, 1.0],
                              [list(hold), list(hold), nan3, nan3])


def test_nan_injection_raises_health_error_with_checkpoint(tmp_path):
    d = str(tmp_path)
    runlog = os.path.join(d, "run.jsonl")
    eng = _engine(field=_nan_after())
    with pytest.raises(HealthError) as ei:
        eng.run(20, chunk=10, checkpoint_dir=d,
                telemetry=Telemetry(runlog=runlog))
    err = ei.value
    assert err.chunk_index == 1 and err.kind == "nonfinite"
    assert err.signals["nonfinite"] > 0
    assert err.checkpoint_path is not None
    assert os.path.exists(err.checkpoint_path)
    assert "last-good checkpoint" in str(err)
    events = read_runlog(runlog)
    assert events[-1]["event"] == "run_end"
    assert events[-1]["status"] == "failed"
    recs = [e for e in events if e["event"] == "chunk"]
    assert recs[-1]["verdict"] == "fail" and "error" in recs[-1]
    # the failing chunk never became a checkpoint
    assert os.path.basename(err.checkpoint_path) == "step_000000010"
    # abort and resume: a clean engine restores the last good checkpoint
    clean = _engine(field=(0.0, 0.0, 5.0))
    gen = clean.restore(d)
    assert gen is None and clean.state.step == 10
    clean.run(10, chunk=10)
    assert torch.isfinite(clean.state.pos).all()
    assert torch.isfinite(clean.state.spin).all()
    # the partial trace (chunks up to the abort) kept its health rows
    assert eng.trace.health["nonfinite"].shape == (2,)
    assert eng.trace.health["nonfinite"][-1] > 0


def test_clean_run_passes_thresholds(tmp_path):
    runlog = str(tmp_path / "run.jsonl")
    eng = _engine()   # temperature None: NVE
    eng.run(20, chunk=10, telemetry=Telemetry(
        runlog=runlog, health=HealthConfig(max_energy_drift=0.2,
                                           max_spin_dev=1e-3)))
    h = eng.trace.health
    assert set(h) == {"e_drift", "spin_dev", "nonfinite", "nbr_occ"}
    assert all(v.shape == (2,) for v in h.values())
    assert h["nonfinite"].sum() == 0
    assert np.abs(h["e_drift"]).max() < 0.2
    assert h["spin_dev"].max() < 1e-3
    events = read_runlog(runlog)
    recs = [e for e in events if e["event"] == "chunk"]
    assert [r["verdict"] for r in recs] == ["ok", "ok"]
    assert all("e_drift" in r["health"] for r in recs)
    assert events[-1]["status"] == "ok"
    assert events[-1]["metrics"]["counters"]["steps"] == 20


def test_threshold_violation_is_structured():
    eng = _engine(temperature=300.0)
    with pytest.raises(HealthError) as ei:
        eng.run(10, torch.Generator().manual_seed(5), chunk=10,
                telemetry=Telemetry(
                    health=HealthConfig(max_energy_drift=1e-12)))
    err = ei.value
    assert err.chunk_index == 0 and err.kind == "drift"
    assert "energy drift" in str(err)
    assert math.isfinite(err.signals["e_drift"])
    assert err.checkpoint_path is None  # the run was not checkpointing


def test_runlog_schema_and_tail_repair(tmp_path):
    runlog = str(tmp_path / "run.jsonl")
    eng = _engine()
    eng.run(20, chunk=10, telemetry=runlog)
    events = read_runlog(runlog)
    assert [e["event"] for e in events] == \
        ["run_start", "chunk", "chunk", "run_end"]
    start = events[0]
    assert start["schema"] == 1 and start["plan"] == "SingleDevice"
    assert start["n_atoms"] == 64 and start["chunk"] == 10
    prov = start["provenance"]
    assert prov["torch_version"] == torch.__version__
    assert "jax_version" not in prov
    for rec in events[1:3]:
        assert {"steps", "steps_per_s", "wall_s", "compiles", "health",
                "verdict", "rebuilds"} <= set(rec)
        assert "halo" not in rec          # the flat plan moves no halos
    assert events[-1]["total_steps"] == 20
    # a crash mid-write leaves a torn line: tolerant reads skip it, and
    # repair_tail terminates it so the next record stays whole
    with open(runlog, "a") as fh:
        fh.write('{"event": "chu')
    with pytest.raises(json.JSONDecodeError):
        read_runlog(runlog)
    assert len(read_runlog(runlog, tolerant=True)) == 4
    assert repair_tail(runlog) and not repair_tail(runlog)
    append_event(runlog, "rollback", step=10)
    recs = read_runlog(runlog, tolerant=True)
    assert recs[-1]["event"] == "rollback" and recs[-1]["step"] == 10


def test_bad_telemetry_type_rejected():
    eng = _engine()
    with pytest.raises(TypeError, match="telemetry"):
        eng.run(10, chunk=10, telemetry=42)


def test_telemetry_requires_fused_path():
    lat = simple_cubic()
    sim = Simulation(potential=HeisenbergDMIModel(d0=0.008),
                     cfg=IntegratorConfig(dt=2e-3), state=_state(0),
                     masses=torch.tensor(lat.masses, dtype=torch.float64),
                     magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                     capacity=8, skin=0.2, fused=False, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        sim.run(10, chunk=10, telemetry="x.jsonl")


class _FirstCallLoads:
    """A potential whose first evaluation loads a kernel library, as the
    card's first K1/K2 launch does."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def compute(self, *args):
        self.calls += 1
        if self.calls == 1:
            _build.EVENTS["loads"] += 1
        return self.inner.compute(*args)


def test_watchdog_reads_zero_after_warmup(tmp_path):
    dog = CompileWatchdog()
    mark = dog.mark()
    _build.EVENTS["builds"] += 1
    assert dog.since(mark) == 1
    runlog = str(tmp_path / "run.jsonl")
    eng = _engine()
    pot = _FirstCallLoads(eng.potential)
    eng.potential = pot
    # its first evaluation is the first step of the run's first chunk
    eng.run(30, chunk=10, telemetry=Telemetry(runlog=runlog,
                                              profile_dir=tmp_path / "prof"))
    recs = [e for e in read_runlog(runlog) if e["event"] == "chunk"]
    assert [r["compiles"] for r in recs] == [1, 0, 0]
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"repro.force", "repro.integrate", "repro.observe"} <= names


def test_profiler_that_cannot_start_fails_the_run(tmp_path, monkeypatch):
    """A trace that was asked for and cannot be taken is an error, never a
    warning: the run does not start and the runlog records the failure."""
    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    runlog = str(tmp_path / "run.jsonl")
    eng = _engine()
    with pytest.raises(RuntimeError, match="no profiler here"):
        eng.run(10, chunk=10, telemetry=Telemetry(
            runlog=runlog, profile_dir=tmp_path / "prof"))
    assert eng.state.step == 0
    assert read_runlog(runlog)[-1]["status"] == "failed"
