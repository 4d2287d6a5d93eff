"""The port's slice as a whole: its Engine against the JAX Engine.

The JAX Engine runs in an f64 subprocess (x64, autodiff NEP-SPIN, small
spec) and writes its weights, observables and final state to an ``.npz``;
the port's Engine runs on the CPU at f64 from the same numpy arrays and the
same weights (``params_from_jax``).  B20 4x4x4 with the linked-cell table
(3^3 grid), capacity 64, skin 0.2, 500 K initial velocities, NVE, 2 chunks
x 20 steps with at least one rebuild on both sides.  NVE trajectories are
deterministic, so they agree to f64 roundoff: 1e-9 relative.  A second
pair of runs drives both engines with schedules - a field ramp and a
constant 0 K temperature schedule with the Langevin and Gilbert
thermostats on (noise is drawn but scaled by zero, so the run stays
deterministic) - and streams all six observables, ``pitch`` among them,
every 5 steps; the streams and final states agree within 1e-9 too.

Also: ``callback`` runs once per chunk with the observation state synced,
a caller-supplied initial table is the one used, a run ending in a chunk
shorter than ``obs_every`` emits no row for it and agrees with the
reference's, an Engine built without ``device=`` on a host with no CUDA
raises, and no file of the port imports ``jax`` or the JAX package.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.ensemble import protocol
from repro_torch.core.potential import NEPSpinPotential, params_from_jax
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import b20_fege
from repro_torch.md.state import state_from_numpy
from repro_torch.utils import units
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6, hidden=16)
RUN = dict(cutoff=5.0, capacity=64, skin=0.2, use_cell_list=True,
           cell_capacity=48)
FIELD = (0.0, 0.0, 0.5)
STEPS, CHUNK = 40, 20
# softens the random network (its output layer) for both engines: at full
# scale random weights drift the NVE energy by tens of eV in 20 steps and
# the chaotic trajectory amplifies summation-order roundoff past 1e-9
W2_SCALE = 0.05
# the scheduled pair of runs
SCHED_OBS = ("energy", "kinetic", "magnetization", "charge",
             "skyrmion_count", "pitch")
SCHED_CFG = dict(dt=1e-3, lattice_gamma=1.0, spin_alpha=0.1)
OBS_EVERY = 5
# a run after the scheduled one whose last chunk (2 steps) is shorter than
# OBS_EVERY
TAIL_STEPS = CHUNK + 2


def _schedules(p):
    return (p.constant(0.0),
            p.linear(0.0, 0.03, [0.0, 0.0, 0.0], [0.0, 0.4, 2.0]))

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.descriptor import NEPSpinSpec
from repro.core.potential import NEPSpinPotential, init_params
from repro.ensemble import protocol
from repro.md.engine import Engine
from repro.md.integrator import IntegratorConfig
from repro.md.lattice import b20_fege
from repro.md.state import SpinLatticeState

(spec_kw, run_kw, field, steps, chunk, w2_scale, obs, cfg_kw,
 obs_every, tail_steps) = eval(sys.argv[3])
d = np.load(sys.argv[1])
lat = b20_fege()
st = SpinLatticeState(pos=jnp.asarray(d["pos"]), vel=jnp.asarray(d["vel"]),
                      spin=jnp.asarray(d["spin"]),
                      types=jnp.asarray(d["types"], jnp.int32),
                      box=jnp.asarray(d["box"]),
                      step=jnp.asarray(0, jnp.int32))
spec = NEPSpinSpec(**spec_kw)
params = init_params(spec, jax.random.PRNGKey(4), dtype=jnp.float64)
params = params._replace(w2=w2_scale * params.w2)
pot = NEPSpinPotential(spec, params, moments=jnp.asarray([1.16, 0.0]))
eng = Engine(potential=pot, cfg=IntegratorConfig(dt=1e-3), state=st,
             masses=jnp.asarray(lat.masses),
             magnetic=jnp.asarray(lat.moments) > 0,
             field=jnp.asarray(field), **run_kw)
e0 = eng.energy
eng.run(steps, jax.random.PRNGKey(0), chunk=chunk)
out = {f"param_{i}": np.asarray(x) for i, x in enumerate(params)}
out.update({f"obs_{k}": np.asarray(v) for k, v in eng.trace.values.items()})
# the scheduled run: a field ramp, 0 K thermostats, streamed observables
temp_s = protocol.constant(0.0)
field_s = protocol.linear(0.0, 0.03, [0.0, 0.0, 0.0], [0.0, 0.4, 2.0])
sch = Engine(potential=pot, cfg=IntegratorConfig(**cfg_kw), state=st,
             masses=jnp.asarray(lat.masses),
             magnetic=jnp.asarray(lat.moments) > 0, temperature=temp_s,
             field=field_s, observables=obs, obs_every=obs_every, **run_kw)
sch.run(steps, jax.random.PRNGKey(3), chunk=chunk)
out.update({f"sched_{k}": np.asarray(v) for k, v in sch.trace.values.items()})
out.update({f"sched_final_{k}": np.asarray(getattr(sch.state, k))
            for k in ("pos", "vel", "spin")})
out["sched_time"] = sch.trace.time
out["sched_rebuilds"] = sch.n_rebuilds
# then on, ending in a chunk shorter than obs_every (it emits no row)
sch.run(tail_steps, jax.random.PRNGKey(5), chunk=chunk)
out.update({f"tail_{k}": np.asarray(v) for k, v in sch.trace.values.items()})
out.update({f"tail_final_{k}": np.asarray(getattr(sch.state, k))
            for k in ("pos", "vel", "spin")})
np.savez(sys.argv[2], e0=e0, n_rebuilds=eng.n_rebuilds,
         pos=np.asarray(eng.state.pos), vel=np.asarray(eng.state.vel),
         spin=np.asarray(eng.state.spin), tail_time=sch.trace.time,
         tail_rebuilds=sch.n_rebuilds, tail_step=int(sch.state.step),
         **out)
"""


def _initial_state(seed=0):
    lat = b20_fege()
    pos, types, box = lat.supercell(4, 4, 4)
    rng = np.random.default_rng(seed)
    m = lat.masses[types]
    sigma = np.sqrt(units.KB * 500.0 / (m * units.MVV2E))
    vel = sigma[:, None] * rng.standard_normal(pos.shape)
    vel -= vel.mean(axis=0, keepdims=True)
    spin = rng.standard_normal(pos.shape)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    spin[lat.moments[types] == 0] = 0.0
    return lat, dict(pos=pos, vel=vel, spin=spin, types=types, box=box)


@pytest.fixture(scope="module")
def both_engines(tmp_path_factory):
    lat, arrays = _initial_state()
    d = tmp_path_factory.mktemp("engine")
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), repr((SPEC, RUN, FIELD, STEPS, CHUNK, W2_SCALE,
                                   SCHED_OBS, SCHED_CFG, OBS_EVERY,
                                   TAIL_STEPS))],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(d / "out.npz")

    f64 = torch.float64
    spec = NEPSpinSpec(**SPEC)
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=f64)
    pot = NEPSpinPotential(spec, params, torch.tensor([1.16, 0.0], dtype=f64),
                           use_kernel=True)
    eng = Engine(potential=pot, cfg=IntegratorConfig(dt=1e-3),
                 state=state_from_numpy(**arrays, dtype=f64, device="cpu"),
                 masses=torch.tensor(lat.masses, dtype=f64),
                 magnetic=torch.tensor(lat.moments) > 0, field=FIELD,
                 device="cpu", **RUN)
    e0 = eng.energy
    eng.run(STEPS, chunk=CHUNK)
    temp_s, field_s = _schedules(protocol)
    sch = Engine(potential=pot, cfg=IntegratorConfig(**SCHED_CFG),
                 state=state_from_numpy(**arrays, dtype=f64, device="cpu"),
                 masses=torch.tensor(lat.masses, dtype=f64),
                 magnetic=torch.tensor(lat.moments) > 0, temperature=temp_s,
                 field=field_s, observables=SCHED_OBS, obs_every=OBS_EVERY,
                 device="cpu", **RUN)
    sch.run(STEPS, torch.Generator().manual_seed(3), chunk=CHUNK)
    eng.scheduled = sch
    tail = Engine(potential=pot, cfg=IntegratorConfig(**SCHED_CFG),
                  state=state_from_numpy(**arrays, dtype=f64, device="cpu"),
                  masses=torch.tensor(lat.masses, dtype=f64),
                  magnetic=torch.tensor(lat.moments) > 0,
                  temperature=temp_s, field=field_s, observables=SCHED_OBS,
                  obs_every=OBS_EVERY, device="cpu", **RUN)
    gen = torch.Generator().manual_seed(3)
    tail.run(STEPS, gen, chunk=CHUNK)
    tail.run(TAIL_STEPS, gen, chunk=CHUNK)
    eng.tail = tail
    return ref, eng, e0


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))


def test_engine_rebuilds_match(both_engines):
    ref, eng, _ = both_engines
    assert int(ref["n_rebuilds"]) >= 1
    assert eng.n_rebuilds == int(ref["n_rebuilds"])


@pytest.mark.parametrize("name", ["energy", "kinetic", "magnetization",
                                  "charge"])
def test_engine_observables_match(both_engines, name):
    ref, eng, e0 = both_engines
    assert abs(e0 - float(ref["e0"])) / abs(float(ref["e0"])) < 1e-9
    assert eng.trace.values[name].shape == ref[f"obs_{name}"].shape
    assert _rel(eng.trace.values[name], ref[f"obs_{name}"]) < 1e-9


@pytest.mark.parametrize("field", ["pos", "vel", "spin"])
def test_engine_final_state_matches(both_engines, field):
    ref, eng, _ = both_engines
    assert _rel(getattr(eng.state, field), ref[field]) < 1e-9


def test_scheduled_run_matches(both_engines):
    """Field ramp + 0 K thermostats: the streamed observables (every
    OBS_EVERY steps, pitch included) and the final state."""
    ref, eng, _ = both_engines
    sch = eng.scheduled
    n_emit = STEPS // OBS_EVERY
    np.testing.assert_allclose(sch.trace.time, ref["sched_time"],
                               rtol=1e-12)
    assert sch.trace.time.shape == (n_emit,)
    assert sch.n_rebuilds == int(ref["sched_rebuilds"])
    for name in SCHED_OBS:
        got, want = sch.trace.values[name], ref[f"sched_{name}"]
        assert got.shape == want.shape and got.shape[0] == n_emit, name
        assert _rel(got, want) < 1e-9, name
    for field in ("pos", "vel", "spin"):
        assert _rel(getattr(sch.state, field),
                    ref[f"sched_final_{field}"]) < 1e-9, field
    # the health signals stay at chunk cadence
    assert sch.trace.health["e_drift"].shape == (STEPS // CHUNK,)


def test_tail_shorter_than_obs_every_matches(both_engines):
    """A run whose last chunk (2 steps) is shorter than OBS_EVERY: the
    tail's steps run, it emits no row, and the run goes on as the
    reference's does."""
    ref, eng, _ = both_engines
    tail = eng.tail
    assert tail.state.step == int(ref["tail_step"]) == STEPS + TAIL_STEPS
    assert tail.n_rebuilds == int(ref["tail_rebuilds"])
    n_emit = CHUNK // OBS_EVERY
    np.testing.assert_allclose(tail.trace.time, ref["tail_time"],
                               rtol=1e-12)
    assert tail.trace.time.shape == (n_emit,)
    for name in SCHED_OBS:
        got, want = tail.trace.values[name], ref[f"tail_{name}"]
        assert got.shape == want.shape and got.shape[0] == n_emit, name
        assert _rel(got, want) < 1e-9, name
    for field in ("pos", "vel", "spin"):
        assert _rel(getattr(tail.state, field),
                    ref[f"tail_final_{field}"]) < 1e-9, field
    assert tail.trace.health["e_drift"].shape == (2,)


def _small_engine(state=None, **kw):
    lat, arrays = _initial_state(seed=1)
    f64 = torch.float64
    spec = NEPSpinSpec(**SPEC)
    from repro_torch.core.potential import init_params
    params = init_params(spec, torch.Generator().manual_seed(1), dtype=f64,
                         device="cpu")
    params = params._replace(w2=W2_SCALE * params.w2)
    st = state or state_from_numpy(**arrays, dtype=f64, device="cpu")
    return Engine(potential=NEPSpinPotential(spec, params, use_kernel=True),
                  cfg=IntegratorConfig(dt=1e-3), state=st,
                  masses=torch.tensor(lat.masses, dtype=f64),
                  magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                  capacity=64, skin=0.2, device="cpu", **kw)


def test_engine_honors_swapped_state_and_needs_generator():
    eng = _small_engine()
    eng.run(3, chunk=3)
    swapped = eng.state._replace(vel=torch.zeros_like(eng.state.vel))
    eng.state = swapped
    eng.run(2, chunk=2)
    fresh = _small_engine(state=swapped)
    fresh.run(2, chunk=2)
    assert eng.state.step == fresh.state.step == 5
    for field in ("pos", "vel", "spin"):
        torch.testing.assert_close(getattr(eng.state, field),
                                   getattr(fresh.state, field), rtol=0,
                                   atol=0)
    with pytest.raises(ValueError, match="Generator"):
        eng.run(1, temperature=300.0)
    eng.run(2, torch.Generator().manual_seed(0), chunk=2, temperature=300.0)
    assert eng.state.step == 7 and eng.trace.values["energy"].shape == (1,)


def test_callback_once_per_chunk_with_synced_state():
    eng = _small_engine()
    seen = []

    def callback(e):
        assert e is eng and e.state is e._obs_state
        torch.testing.assert_close(e.state.pos,
                                   e._carry.state.pos[torch.argsort(
                                       e._carry.perm)], rtol=0, atol=0)
        seen.append((e.state.step, e.n_rebuilds))

    eng.run(10, chunk=4, callback=callback)
    assert [s for s, _ in seen] == [4, 8, 10]
    # a callback may swap the state: the next chunk starts from it
    eng.run(4, chunk=2, callback=lambda e: setattr(
        e, "state", e.state._replace(vel=torch.zeros_like(e.state.vel))))
    assert eng.state.step == 14


def test_caller_supplied_table_is_used():
    from repro_torch.md.neighbor import dense_neighbor_table, gather_blocks
    lat, arrays = _initial_state(seed=1)
    st = state_from_numpy(**arrays, dtype=torch.float64, device="cpu")
    short = dense_neighbor_table(st.pos, st.box, 3.0, 64, skin=0.0)
    eng = _small_engine(state=st, table=short)
    assert eng.table is short
    want = eng.potential.compute(gather_blocks(st.pos, st.types, short,
                                               st.box), st.spin, st.types)
    assert eng.energy == float(want[0])
    assert eng.energy != _small_engine(state=st).energy


def test_engine_cell_order_is_layout_only():
    """Cell-ordered rows (the default with the cell list) and input-order
    rows give the same trajectory, up to summation order."""
    from repro_torch.parallel.plan import SingleDevice, as_plan
    runs = [_small_engine(plan=SingleDevice(cell_order=order),
                          use_cell_list=True, cell_capacity=48)
            for order in (None, False)]
    for eng in runs:
        eng.run(6, chunk=3)
    assert runs[0]._reorder and not runs[1]._reorder
    for field in ("pos", "vel", "spin"):
        torch.testing.assert_close(getattr(runs[0].state, field),
                                   getattr(runs[1].state, field), rtol=1e-10,
                                   atol=1e-10)
    # the Sharded plan runs (tests/test_torch_sharded.py), and so do
    # replicas on its spatial mesh: two identical replicas at construction
    rep = _small_engine(plan=as_plan("sharded", replicas=2))
    assert rep.state.pos.shape[0] == 2 and rep.energy.shape == (2,)
    assert torch.equal(rep.state.pos[0], rep.state.pos[1])
    assert rep.energy[0] == rep.energy[1]


def test_engine_needs_device_when_no_card(monkeypatch):
    lat, arrays = _initial_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = state_from_numpy(**arrays, dtype=torch.float64, device="cpu")
    spec = NEPSpinSpec(**SPEC)
    from repro_torch.core.potential import init_params
    params = init_params(spec, torch.Generator().manual_seed(0),
                         dtype=torch.float64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(potential=NEPSpinPotential(spec, params),
               cfg=IntegratorConfig(), state=st,
               masses=torch.tensor(lat.masses, dtype=torch.float64),
               magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
