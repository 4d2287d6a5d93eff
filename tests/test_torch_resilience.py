"""The port's fault injection and supervised recovery
(``repro_torch.resilience``, ``Engine.rebind``): the flat-plan cases of
``tests/test_resilience.py`` in the port, the replica plan's rebind, the
serving rung with a stub hook, and the injector's choice of elements held
against the reference's injector on carries of the same shape.

Each recovered or resumed trajectory is held bitwise to the port's own
uninterrupted run (the reference's contract, as a property of the port).
"""
import os
import signal
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import b20_fege, simple_cubic
from repro_torch.md.state import init_state
from repro_torch.parallel.plan import Replicated, Sharded
from repro_torch.resilience import (Fault, FaultPlan, Supervisor,
                                    SupervisorConfig, install_faults)
from repro_torch.resilience.supervisor import (Strikes, attribute_slot,
                                               backoff_delay)
from repro_torch.telemetry import (HealthConfig, HealthError, Telemetry,
                                   read_runlog, spin_norm_dev)
from torch_one_thread import one_torch_thread  # noqa: F401

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _make_engine(cells=(4, 4, 4), **kw):
    lat = simple_cubic()
    st = init_state(lat, cells, temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(3),
                    device="cpu")
    return Engine(potential=HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=st, masses=torch.tensor(lat.masses,
                                                dtype=torch.float32),
                  magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                  capacity=8, skin=0.2,
                  observables=("energy", "magnetization"), device="cpu",
                  **kw)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _assert_bitwise(a, b):
    for leaf in ("pos", "vel", "spin"):
        x, y = getattr(a, leaf), getattr(b, leaf)
        assert torch.equal(x, y), f"{leaf}: max {float((x - y).abs().max())}"


@pytest.fixture(scope="module")
def flat_recovery(tmp_path_factory):
    """One clean run and one supervised NaN-faulted run."""
    tmp = tmp_path_factory.mktemp("resil")
    log = str(tmp / "run.jsonl")
    ref = _make_engine()
    ref.run(40, _gen(), chunk=10)
    eng = _make_engine()
    inj = install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=25, leaf="force"),)), runlog=log)
    sup = Supervisor(SupervisorConfig(max_retries=2))
    out = sup.run(eng, 40, _gen(), chunk=10, checkpoint_dir=str(tmp / "ck"),
                  telemetry=Telemetry(runlog=log, health=HealthConfig()))
    return {"ref": ref.state, "out": out, "sup": sup, "inj": inj,
            "log": log, "eng": eng}


def test_supervised_nan_recovery_bitwise(flat_recovery):
    """An injected NaN is rolled back (carry and generator) and retried; the
    recovered trajectory is bitwise the uninterrupted run's."""
    r = flat_recovery
    assert [e["event"] for e in r["sup"].events] == \
        ["rollback", "retry", "recovered"]
    assert r["sup"].events[0]["kind"] == "nonfinite"
    assert r["inj"].fired == [{"kind": "nan", "fault_step": 25,
                               "chunk_step": 20, "leaf": "force",
                               "device": 0}]
    assert r["eng"]._step_now() == 40
    _assert_bitwise(r["ref"], r["out"])


def test_recovery_events_in_runlog(flat_recovery):
    """Every recovery action lands in the runlog, and the port's report
    renders each."""
    from repro_torch.launch.report import runlog_report
    events = [rec["event"] for rec in read_runlog(flat_recovery["log"])]
    for ev in ("fault_injected", "rollback", "retry", "recovered"):
        assert ev in events, events
    text = runlog_report(flat_recovery["log"])
    for token in ("fault_injected: nan at step 25 (leaf force)",
                  "rollback #1: nonfinite at step 30", "retry #1",
                  "recovered after 1 attempt(s) at step 40",
                  "across 2 run segment(s)"):
        assert token in text, (token, text)


def test_zero_builds_on_retry(flat_recovery):
    """No kernel is built or loaded after the rollback: every chunk record
    after it shows 0."""
    records = read_runlog(flat_recovery["log"])
    first_rb = next(i for i, rec in enumerate(records)
                    if rec["event"] == "rollback")
    after = [rec["compiles"] for rec in records[first_rb:]
             if rec["event"] == "chunk"]
    assert after and all(c == 0 for c in after), after


def test_bit_flip_recovery_bitwise(tmp_path):
    """A bit flip (the top exponent bit of one spin component, 62 clamped
    to 30 for f32) is detected and recovered bitwise."""
    ref = _make_engine()
    ref.run(40, _gen(), chunk=10)
    eng = _make_engine()
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="bit_flip", step=15, leaf="spin", bit=30),)))
    sup = Supervisor(SupervisorConfig(max_retries=2))
    out = sup.run(eng, 40, _gen(), chunk=10, checkpoint_dir=str(tmp_path),
                  telemetry=Telemetry(health=HealthConfig()))
    assert [e["event"] for e in sup.events] == \
        ["rollback", "retry", "recovered"]
    _assert_bitwise(ref.state, out)


def _b20_engine():
    """A 3^3 B20 FeGe engine (Fe magnetic, Ge spin 0) under the
    Heisenberg-DMI model, whose couplings read Fe spins only."""
    lat = b20_fege()
    st = init_state(lat, (3, 3, 3), temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(4),
                    device="cpu")
    return Engine(potential=HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=st, masses=torch.tensor(lat.masses,
                                                dtype=torch.float32),
                  magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                  capacity=64, skin=0.2, device="cpu")


def test_spin_norm_dev_holds_non_magnetic_spins_at_zero():
    """A magnetic row counts | |s| - 1 |, any other row |s|."""
    spin = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [0.0, 2.0, 0.0],
                         [0.0, 0.0, 0.5]])
    mag = torch.tensor([True, False, False, True])
    assert float(spin_norm_dev(spin, mag)) == 2.0
    assert float(spin_norm_dev(spin[[0, 1, 3]], mag[[0, 1, 3]])) == 0.5


def test_bit_flip_on_a_non_magnetic_spin_is_caught(tmp_path):
    """A bit flip on a Ge spin (0 -> 2.0: finite, and read by no coupling
    of this model) is caught by the spin signal and recovered bitwise.
    The plan's seed is the first that picks a Ge row of the faulted
    chunk's carry."""
    ref = _b20_engine()
    types = []
    ref.run(40, _gen(), chunk=10, callback=lambda e: types.append(
        e._carry.state.types.numpy().copy()) if e._step_now() == 10
        else None)
    rows = np.arange(types[0].size)
    seed = next(s for s in range(64) if types[0][np.random.default_rng(
        np.random.SeedSequence([s, 0])).choice(rows, 1, False)[0]] == 1)
    eng = _b20_engine()
    inj = install_faults(eng, FaultPlan(faults=(
        Fault(kind="bit_flip", step=15, leaf="spin", bit=30),), seed=seed))
    sup = Supervisor(SupervisorConfig(max_retries=2))
    out = sup.run(eng, 40, _gen(), chunk=10, checkpoint_dir=str(tmp_path),
                  telemetry=Telemetry(health=HealthConfig(max_spin_dev=1e-3)))
    assert len(inj.fired) == 1
    assert [e["event"] for e in sup.events] == \
        ["rollback", "retry", "recovered"]
    assert sup.events[0]["kind"] == "spin"
    _assert_bitwise(ref.state, out)


def test_dt_degradation_ladder(tmp_path):
    """Two consecutive same-class failures climb the dt ladder: rebind at
    dt/2 for a span through the trouble spot, then back to full dt.  The
    fault models a dt-fixable instability (inert below its threshold)."""
    eng = _make_engine()
    inj = install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=25, leaf="spin", once=False,
              while_dt_ge=2e-3),)))
    sup = Supervisor(SupervisorConfig(max_retries=4, degrade_after=2))
    out = sup.run(eng, 40, _gen(), chunk=10, checkpoint_dir=str(tmp_path),
                  telemetry=Telemetry(health=HealthConfig()))
    evs = [e["event"] for e in sup.events]
    assert evs == ["rollback", "retry", "rollback", "degrade",
                   "degrade_restore", "retry", "recovered"], evs
    degrade = next(e for e in sup.events if e["event"] == "degrade")
    assert degrade["action"] == "dt"
    assert degrade["dt"] == pytest.approx(1e-3)
    assert degrade["span_steps"] == 20
    assert eng.cfg.dt == pytest.approx(2e-3)      # restored
    assert eng._step_now() == 40
    assert bool(torch.isfinite(out.spin).all())
    assert len(inj.fired) == 2                    # inert once dt dropped


def test_give_up_reraises(tmp_path):
    """Past the retry budget the supervisor re-raises the HealthError and
    logs a give_up event."""
    eng = _make_engine()
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=5, leaf="force", once=False),)))
    sup = Supervisor(SupervisorConfig(max_retries=0))
    with pytest.raises(HealthError):
        sup.run(eng, 20, _gen(), chunk=10, checkpoint_dir=str(tmp_path),
                telemetry=Telemetry(health=HealthConfig()))
    assert [e["event"] for e in sup.events] == ["rollback", "give_up"]


def test_fault_validation():
    with pytest.raises(ValueError, match="kind"):
        Fault(kind="gremlin", step=0)
    with pytest.raises(ValueError, match="leaf"):
        Fault(kind="nan", step=0, leaf="mass")
    # overflow / halo target the Sharded plan's per-device state: the flat
    # plan rejects them at install, as the reference's
    eng = _make_engine()
    for kind in ("overflow", "halo"):
        with pytest.raises(ValueError, match="sharded"):
            install_faults(eng, FaultPlan(faults=(Fault(kind=kind,
                                                         step=0),)))


def test_supervisor_helpers():
    assert backoff_delay(0, 1.0) == 0.0 and backoff_delay(1, 0.0) == 0.0
    assert [backoff_delay(a, 0.5) for a in (1, 2, 3)] == [0.5, 1.0, 2.0]
    assert backoff_delay(10, 1.0, cap=30.0) == 30.0
    s = Strikes()
    assert [s.hit("nonfinite"), s.hit("nonfinite"), s.hit("spin"),
            s.hit(None)] == [1, 2, 1, 1]
    assert attribute_slot({"slot_nonfinite": [0, 3, 0]}) == 1
    assert attribute_slot({"slot_spin_dev": [0.0, 0.1, 2.0]}, "spin") == 2
    assert attribute_slot({"slot_e_drift": [0.1, float("nan")]},
                          "drift") == 1
    assert attribute_slot({"e_drift": 1.0}) is None


def test_rebind_keeps_the_trajectory_state(tmp_path):
    """rebind on the flat plan: positions, velocities, spins, step and the
    rebuild count carry over bitwise, the table and forces are rebuilt,
    and a rebind to the same config continues the run (the rebuilt table
    changes only the rounding); a new plan swaps the plan kind - the
    Sharded plan on one rank, then Replicated(2) tiling the flat state -
    and the state carries over bitwise through both."""
    ref = _make_engine()
    ref.run(30, _gen(), chunk=10)
    eng = _make_engine()
    g = _gen()
    eng.run(10, g, chunk=10)
    before = eng.state
    eng.rebind(cfg=eng.cfg)
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(eng.state, k), getattr(before, k))
    assert eng.state.step == 10
    eng.run(20, g, chunk=10)
    for k in ("vel", "spin"):
        x, y = getattr(eng.state, k), getattr(ref.state, k)
        assert float((x - y).abs().max()) < 1e-4, k
    eng.rebind(skin=0.3)
    assert eng.skin == 0.3 and eng.state.step == 30
    before = eng.state
    eng.rebind(plan="sharded")
    assert isinstance(eng.plan, Sharded) and eng.state.step == 30
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(eng.state, k), getattr(before, k))
    eng.rebind(plan=Replicated(2))
    assert eng.state.pos.shape[0] == 2 and list(eng.state.step) == [30, 30]
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(eng.state, k)[1], getattr(before, k))
    eng.run(10, [_gen(1), _gen(2)], chunk=10)
    assert list(eng.state.step) == [40, 40]


def test_rebind_on_the_replicated_plan():
    """rebind on Replicated(2): the batch keeps its states and per-slot
    clocks bitwise, runs on at the new dt, and K1/K2's shared table is
    rebuilt from the batch."""
    lat = simple_cubic()
    st = init_state(lat, (4, 4, 4), temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(3),
                    device="cpu")
    eng = Engine(potential=HeisenbergDMIModel(d0=0.008),
                 cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                      lattice_gamma=1.0),
                 state=st, masses=torch.tensor(lat.masses,
                                               dtype=torch.float32),
                 magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                 capacity=8, skin=0.2, plan=Replicated(2), device="cpu")
    gens = [_gen(1), _gen(2)]
    eng.run(10, gens, chunk=10)
    before = eng.state
    reb = eng.n_rebuilds
    eng.rebind(cfg=IntegratorConfig(dt=1e-3, spin_alpha=0.05,
                                    lattice_gamma=1.0))
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(eng.state, k), getattr(before, k))
    assert list(eng.state.step) == [10, 10] and eng.n_rebuilds == reb
    assert eng.cfg.dt == 1e-3
    eng.run(10, gens, chunk=10)
    assert list(eng.state.step) == [20, 20]
    assert bool(torch.isfinite(eng.state.pos).all())


def test_evict_rung_with_a_stub_hook(tmp_path):
    """With an ``evict_slot_hook`` the second same-class failure takes the
    serving rung instead of the dt ladder: the hook sees the HealthError,
    its info lands in an ``evict`` event, dt never changes."""
    eng = _make_engine()
    seen = []

    def hook(err):
        seen.append(err.kind)
        return {"slot": 1, "job": "j7", "tenant": "t0"}

    eng.evict_slot_hook = hook
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=25, leaf="spin", once=False),)))
    sup = Supervisor(SupervisorConfig(max_retries=2, degrade_after=2))
    with pytest.raises(HealthError):
        sup.run(eng, 40, _gen(), chunk=10, checkpoint_dir=str(tmp_path),
                telemetry=Telemetry(health=HealthConfig()))
    evs = [e["event"] for e in sup.events]
    assert evs == ["rollback", "retry", "rollback", "evict", "retry",
                   "rollback", "give_up"], evs
    ev = next(e for e in sup.events if e["event"] == "evict")
    assert ev["slot"] == 1 and ev["job"] == "j7" and ev["kind"] == \
        "nonfinite"
    assert seen == ["nonfinite"] and eng.cfg.dt == 2e-3


def test_capacity_rung_and_elastic_restore_name_their_item(tmp_path):
    """The overflow rung rebinds a (one-rank) Sharded engine at twice its
    cell capacity with a ``degrade`` event and re-saves the rollback
    target in the new layout; ``elastic_restore`` re-bins a Sharded
    checkpoint onto a plan of another capacity with its event, and names
    the reference's limit on a flat engine."""
    sup = Supervisor()
    eng = _make_engine(cells=(6, 6, 6), plan=Sharded())
    cap0 = eng._rplan.dspec.capacity
    before = eng.state
    sup._degrade(eng, "overflow", None, 10, str(tmp_path / "ck"), 1, None,
                 40, None, {})
    assert eng._rplan.dspec.capacity == 2 * cap0
    ev = sup.events[-1]
    assert (ev["event"], ev["action"], ev["prev_capacity"],
            ev["cell_capacity"]) == ("degrade", "capacity", cap0, 2 * cap0)
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(eng.state, k), getattr(before, k))
    assert eng.restore(str(tmp_path / "ck")) is None   # the new layout
    eng.run(10, chunk=10, checkpoint_dir=str(tmp_path / "ck2"))
    fresh = _make_engine(cells=(6, 6, 6), plan=Sharded())
    sup.elastic_restore(fresh, str(tmp_path / "ck2"),
                        Sharded(cell_capacity=cap0 + 1))
    ev = sup.events[-1]
    assert ev["event"] == "elastic_restore" and ev["step"] == 10
    assert (ev["from_layout"]["cell_capacity"],
            ev["to_layout"]["cell_capacity"]) == (cap0, cap0 + 1)
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(fresh.state, k), getattr(eng.state, k))
    with pytest.raises(NotImplementedError, match="single-trajectory"):
        sup.elastic_restore(_make_engine(), "ck", plan=Sharded())


# ---------------------------------------------------------------------------
# the injector's choice of elements, against the reference's
# ---------------------------------------------------------------------------

class _St(NamedTuple):
    pos: object
    vel: object
    spin: object
    types: object
    step: object


class _FF(NamedTuple):
    force: object


class _Flat(NamedTuple):
    state: object
    ff: object


class _Rep(NamedTuple):
    states: object
    ffs: object


def _carries(shape, replica: bool):
    """Same-shaped carries for the reference (jax arrays) and the port
    (torch tensors), f32, filled with a smooth nonzero pattern."""
    import jax.numpy as jnp
    n = int(np.prod(shape[:-1]))
    base = (np.arange(n * 3, dtype=np.float32).reshape(shape) % 7 + 1) / 8
    types = np.zeros(shape[:-1], np.int32)
    step = np.full(shape[0], 20) if replica else 20
    wrap = _Rep if replica else _Flat

    def build(arr, ints):
        st = _St(arr(base), arr(base + 1), arr(base + 2), ints(types), step)
        return wrap(st, _FF(arr(base + 3)))

    return (build(jnp.asarray, jnp.asarray),
            build(torch.tensor, torch.tensor))


@pytest.mark.parametrize("replica", [False, True])
@pytest.mark.parametrize("fault", [
    dict(kind="nan", leaf="force", count=3),
    dict(kind="nan", leaf="spin", count=1),
    dict(kind="bit_flip", leaf="pos", bit=62),
    dict(kind="bit_flip", leaf="vel", bit=12, count=4),
])
def test_injector_picks_the_reference_elements(fault, replica):
    """On carries of the same shape, the port's injector corrupts the same
    rows and columns, with the same bit, as the reference's (flat and
    replica carries; f32, so bit 62 clamps to 30)."""
    import types as pytypes

    from repro.resilience.faults import FaultInjector as RefInjector
    from repro.resilience.faults import FaultPlan as RefPlan
    from repro.resilience.faults import Fault as RefFault
    from repro_torch.resilience.faults import FaultInjector
    shape = (3, 40, 3) if replica else (70, 3)
    ref_carry, port_carry = _carries(shape, replica)
    eng = pytypes.SimpleNamespace(plan=object(),
                                  cfg=pytypes.SimpleNamespace(dt=1e-3))
    f = dict(fault, step=25)
    ref_out = RefInjector(eng, RefPlan(faults=(RefFault(**f),), seed=9))(
        eng, ref_carry, 10)
    out = FaultInjector(eng, FaultPlan(faults=(Fault(**f),), seed=9))(
        eng, port_carry, 10)
    split = (lambda c: (c.states, c.ffs)) if replica else (
        lambda c: (c.state, c.ff))
    def get(c, leaf):
        st, ff = split(c)
        return np.asarray(ff.force if leaf == "force" else getattr(st, leaf))

    for leaf in ("pos", "vel", "spin", "force"):
        a, b = get(ref_out, leaf), get(out, leaf)
        assert b.dtype == a.dtype == np.float32
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), leaf
    hit = get(out, f["leaf"]).view(np.uint32) ^ get(
        port_carry, f["leaf"]).view(np.uint32)
    assert np.count_nonzero(hit) == f.get("count", 1)
    if f["kind"] == "bit_flip":
        assert set(hit[hit != 0].tolist()) == {1 << min(f["bit"], 30)}


# ---------------------------------------------------------------------------
# host crash: SIGKILL mid-run, resume from the newest checkpoint
# ---------------------------------------------------------------------------

def test_sigkill_resume_bitwise(tmp_path):
    """A SIGKILLed child run loses at most one chunk of work; resuming from
    the newest checkpoint reproduces the uninterrupted run bitwise
    (launch/resilience_smoke.py's crash child)."""
    from repro_torch.ckpt.checkpoint import latest_step
    from repro_torch.launch.resilience_smoke import (STEPS, CHUNK,
                                                     make_engine)
    env = dict(os.environ, PYTHONPATH=_SRC)
    ck = str(tmp_path / "ck")
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.launch.resilience_smoke",
                        "--crash-child", ck, "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    assert latest_step(ck) == 20
    ref = make_engine("cpu")
    ref.run(STEPS, _gen(), chunk=CHUNK)
    eng = make_engine("cpu")
    gen = eng.restore(ck)
    start = eng._step_now()
    assert STEPS - start <= 2 * CHUNK
    eng.run(STEPS - start, gen, chunk=CHUNK)
    _assert_bitwise(ref.state, eng.state)
