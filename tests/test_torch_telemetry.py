"""The port's telemetry (ports of ``tests/test_telemetry.py``'s flat-plan
tests): a schedule that goes NaN mid-run raises a structured
``HealthError`` naming the last-good checkpoint, from which a clean engine
resumes; a clean run passes tight thresholds; a violated threshold is
structured; the runlog's ``run_start`` / ``chunk`` / ``run_end`` schema
holds and ``read_runlog`` / ``repair_tail`` handle a torn line; a bad
telemetry argument is rejected; the compile watchdog reads 0 after the
first chunk; a profile directory receives a Chrome trace, and a profiler
that cannot start fails the run.  The engine's layer ranges nest as the
engine's loop does (a ``repro.step`` a step holding one ``repro.skin_test``
with one ``repro.sync``, ``repro.refresh`` inside ``repro.integrate``, a
``repro.readback`` a chunk) on the flat, replica and Sharded plans, and
the ``repro.sync`` ranges are the host-sync counter's delta and the
runlog's ``host_syncs``.
"""
import collections
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
from repro_torch.md.state import init_state, replicate
from repro_torch.parallel.plan import Replicated, Sharded
from repro_torch.telemetry import (CompileWatchdog, HealthConfig,
                                   HealthError, HostSyncCounter, Telemetry,
                                   append_event, read_runlog, repair_tail)
from torch_one_thread import one_torch_thread  # noqa: F401


def _state(seed=3):
    return init_state(simple_cubic(), (4, 4, 4), generator=torch.Generator()
                      .manual_seed(seed), temperature=300.0,
                      spin_init="helix_x", dtype=torch.float64, device="cpu")


def _engine(potential=None, temperature=None, field=None, seed=3, **kw):
    lat = simple_cubic()
    return Engine(potential=potential or HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=_state(seed),
                  masses=torch.tensor(lat.masses, dtype=torch.float64),
                  magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                  capacity=8, skin=0.2, temperature=temperature,
                  field=field, observables=("energy", "magnetization"),
                  device="cpu", **kw)


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


# --- the engine's layer ranges ---------------------------------------------

SPAN_STEPS, SPAN_CHUNK = 30, 10


def _profiled_run(eng, runlog, generator=None):
    """Run the engine under ``torch.profiler`` on the CPU: ``(spans, host
    syncs counted)``, spans as sorted ``(name, start ns, end ns)`` of the
    ``repro.*`` ranges."""
    from torch.profiler import ProfilerActivity, profile
    syncs = HostSyncCounter()
    mark = syncs.mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(SPAN_STEPS, generator, chunk=SPAN_CHUNK,
                telemetry=Telemetry(runlog=runlog, health=None))
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("repro.")
                    and e.device_type() == cpu),
                   key=lambda x: (x[1], -x[2]))
    return spans, syncs.since(mark)


def _parents(spans) -> list:
    """Each span's parent: the index of the innermost span holding it."""
    parent, stack = [], []
    for i, (_, _, end) in enumerate(spans):
        while stack and spans[stack[-1]][2] < end:
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    return parent


def _holds(parent, i: int, k: int) -> bool:
    """Whether span ``i`` holds span ``k`` (at any depth)."""
    while parent[k] is not None:
        k = parent[k]
        if k == i:
            return True
    return False


def _check_tree(spans, counted: int, runlog, steps: int, chunks: int,
                per_rebuild: int | None = None):
    """The layer ranges nest as the engine's loop does, and the
    ``repro.sync`` ranges are the counter's delta and the runlog's
    (``per_rebuild``: the syncs each ``repro.rebuild`` holds)."""
    names = [n for n, _, _ in spans]
    parent = _parents(spans)
    kids = collections.defaultdict(list)
    for i, p in enumerate(parent):
        kids[p].append(i)

    def named(name):
        return [i for i, n in enumerate(names) if n == name]

    def under(i, name):
        return [k for k in kids[i] if names[k] == name]

    def parents_of(name):
        return {names[parent[i]] for i in named(name)}

    assert len(named("repro.run")) == 1
    assert len(named("repro.chunk")) == chunks
    assert parents_of("repro.chunk") == {"repro.run"}
    assert len(named("repro.step")) == steps
    assert parents_of("repro.step") == {"repro.chunk"}
    for i in named("repro.step"):
        test = under(i, "repro.skin_test")
        assert len(test) == 1
        assert len(under(test[0], "repro.sync")) == 1
        assert len(under(i, "repro.integrate")) == 1
    assert len(named("repro.refresh")) == steps
    assert parents_of("repro.refresh") == {"repro.integrate"}
    assert len(named("repro.readback")) == chunks
    assert parents_of("repro.readback") == {"repro.chunk"}
    for i in named("repro.readback"):
        assert len(under(i, "repro.sync")) == 1
    assert named("repro.rebuild")                   # a rebuild was taken
    assert parents_of("repro.rebuild") == {"repro.step"}
    if per_rebuild is not None:
        for i in named("repro.rebuild"):
            assert sum(names[k] == "repro.sync" and _holds(parent, i, k)
                       for k in range(len(names))) == per_rebuild
    assert parents_of("repro.force") <= {"repro.integrate", "repro.rebuild",
                                         "repro.step"}
    sync = named("repro.sync")
    assert not any(kids[i] for i in sync)           # a mark, no layer
    assert len(sync) == counted
    events = read_runlog(runlog)
    recs = [e for e in events if e["event"] == "chunk"]
    first = spans[named("repro.chunk")[0]][1]
    in_chunks = sum(any(_holds(parent, c, i) for c in named("repro.chunk"))
                    for i in sync)
    assert sum(r["host_syncs"] for r in recs) == in_chunks
    assert events[-1]["host_syncs"] == sum(spans[i][1] >= first
                                           for i in sync)
    assert events[-1]["metrics"]["counters"]["host_syncs"] == sum(
        r["host_syncs"] for r in recs)
    return names


def _sharded_spans(rank, d):
    """One rank of the Sharded case: its spans, count, ledger and rebuilds
    to ``d``; rank 0 writes the runlog."""
    torch.set_num_threads(1)
    lat = simple_cubic()
    st = init_state(lat, (8, 4, 4), generator=torch.Generator()
                    .manual_seed(3), temperature=400.0, spin_init="helix_x",
                    dtype=torch.float64, device="cpu")
    eng = Engine(HeisenbergDMIModel(d0=0.008), IntegratorConfig(dt=2e-3),
                 st, masses=torch.tensor(lat.masses, dtype=torch.float64),
                 magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                 capacity=16, skin=0.2, plan=Sharded(),
                 observables=("energy", "magnetization"), device="cpu")
    ledger0 = dict(eng.halo_ledger.counts)
    r0 = eng.n_rebuilds
    spans, counted = _profiled_run(eng, os.path.join(d, "run.jsonl"))
    ledger = {t: c - ledger0.get(t, 0)
              for t, c in eng.halo_ledger.counts.items()}
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump({"spans": spans, "counted": counted, "ledger": ledger,
                   "rebuilds": eng.n_rebuilds - r0}, f)


@pytest.mark.parametrize("plan", ["flat", "replica", "sharded"])
def test_layer_spans_nest_and_count_every_host_sync(plan, tmp_path):
    runlog = str(tmp_path / "run.jsonl")
    if plan == "sharded":
        from repro_torch.parallel.ranks import spawn
        spawn(_sharded_spans, 2, str(tmp_path), workdir=str(tmp_path))
        for rank in (0, 1):
            with open(tmp_path / f"rank{rank}.json") as f:
                got = json.load(f)
            assert got["rebuilds"] >= 1
            spans = [tuple(s) for s in got["spans"]]
            if rank == 0:
                names = _check_tree(spans, got["counted"], runlog,
                                    SPAN_STEPS, SPAN_STEPS // SPAN_CHUNK)
            else:
                names = [n for n, _, _ in spans]
                assert names.count("repro.sync") == got["counted"]
            # every tagged exchange and fold in its repro.halo.<tag> range:
            # the drift's asynchronous exchange twice (issue and wait)
            halo = collections.Counter(n[len("repro.halo."):] for n in names
                                       if n.startswith("repro.halo."))
            assert set(halo) == set(got["ledger"]) >= {"drift-pos",
                                                        "adjoint"}
            assert all(halo[t] >= c for t, c in got["ledger"].items())
            assert halo["drift-pos"] == 2 * got["ledger"]["drift-pos"]
        return
    # the flat plan on linked cells, as the main path: a rebuild reads the
    # binning's index and its overflow flag, copies the stencil to the
    # device and reads the table's transpose
    eng, per_rebuild = _engine(use_cell_list=True), 4
    if plan == "replica":
        lat = simple_cubic()
        eng = Engine(potential=HeisenbergDMIModel(d0=0.008),
                     cfg=IntegratorConfig(dt=2e-3), state=replicate(
                         _state(), 2), plan=Replicated(2),
                     masses=torch.tensor(lat.masses, dtype=torch.float64),
                     magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                     capacity=8, skin=0.2,
                     observables=("energy", "magnetization"), device="cpu")
        per_rebuild = 1        # the dense table's transpose
    r0 = eng.n_rebuilds
    spans, counted = _profiled_run(eng, runlog)
    assert eng.n_rebuilds > r0
    _check_tree(spans, counted, runlog, SPAN_STEPS,
                SPAN_STEPS // SPAN_CHUNK, per_rebuild)
