"""The port's Replicated plan against the JAX package's, and its own bitwise
contracts.

An f64 JAX subprocess (x64) runs, once per module:

* ``jax.vmap`` of the reference's ``nep_compute`` (``mode="xla_tiled"``)
  over a batch of 3 jittered B20 2x2x2 replicas that share one table, with
  a field per replica;
* the reference's ``Engine`` on ``Replicated(3)``: three distinct B20 3x3x3
  states (500 K velocities, random spins), NVE (T = 0), autodiff NEP-SPIN
  with a softened output layer, a field, 2 chunks x 20 steps with at least
  one shared rebuild.

The port runs the same numbers at f64 on the CPU: the batched K1/K2 path
(their plain versions here) within 1e-10 of the vmapped reference, and its
replica Engine (K1/K2 path) within 1e-9 of the reference's over the 40 steps
with the same rebuild count.  Then the port's own contracts: identical
replicas stay bitwise identical through a shared rebuild and bitwise equal
a flat Simulation; a resume is bitwise, flat and replicated; NEP-SPIN runs
through the replica plan under field cooling; a batch is bitwise flat
Engines fed the same generators; and seat-vs-backfill - a job seated at
engine start and the same job written into a slot later follow bitwise the
same trajectory, its batch-mates untouched.
"""
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.core.potential import (NEPSpinPotential, init_params,
                                        params_from_jax)
from repro_torch.ensemble import protocol
from repro_torch.ensemble.replica import (ReplicaEnsemble, replicate,
                                          spawn_generators)
from repro_torch.kernels.nep.ops import nep_compute
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import b20_fege, simple_cubic
from repro_torch.md.neighbor import shared_blocks
from repro_torch.md.simulate import Simulation
from repro_torch.md.state import (init_state, stack_states, state_from_numpy,
                                  unstack_state)
from repro_torch.parallel.plan import Replicated, SingleDevice
from repro_torch.utils import units
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6, hidden=16)
R = 3
FIELDS = [(0.0, 0.0, 0.5), (0.0, 0.3, 0.0), (0.2, 0.0, 0.1)]
RUN = dict(cutoff=5.0, capacity=48, skin=0.2)
STEPS, CHUNK = 40, 20
W2_SCALE = 0.05     # softens the random network (tests/test_torch_engine.py)

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.descriptor import NEPSpinSpec
from repro.core.potential import NEPSpinPotential, init_params
from repro.kernels.nep.ops import nep_compute
from repro.md.engine import Engine
from repro.md.integrator import IntegratorConfig
from repro.md.lattice import b20_fege
from repro.md.neighbor import Neighborhood, dense_neighbor_table
from repro.md.state import SpinLatticeState
from repro.parallel.plan import Replicated

spec_kw, fields, run_kw, steps, chunk, w2_scale = eval(sys.argv[3])
d = np.load(sys.argv[1])
spec = NEPSpinSpec(**spec_kw)
params = init_params(spec, jax.random.PRNGKey(7), dtype=jnp.float64)
out = {f"param_{i}": np.asarray(x) for i, x in enumerate(params)}
mom = jnp.asarray([1.16, 0.0])
# vmapped K1/K2 path on a shared table
pos = jnp.asarray(d["k_pos"])
box = jnp.asarray(d["k_box"])
types = jnp.asarray(d["k_types"], jnp.int32)
idx = jnp.asarray(d["k_idx"])
mask = jnp.asarray(d["k_mask"])
dr = pos[:, idx] - pos[:, :, None, :]
dr = dr - box * jnp.round(dr / box)
def one(dr_r, spin_r, field_r):
    nbh = Neighborhood(idx=idx, mask=mask, tj=types[idx], dr=dr_r)
    return nep_compute(spec, params, nbh, spin_r, types, field_r, mom,
                       mode="xla_tiled")
e, f, h = jax.vmap(one)(dr, jnp.asarray(d["k_spin"]), jnp.asarray(fields))
out.update(k_e=np.asarray(e), k_f=np.asarray(f), k_h=np.asarray(h))
# the replica Engine, NVE, distinct states
lat = b20_fege()
st = SpinLatticeState(pos=jnp.asarray(d["pos"]), vel=jnp.asarray(d["vel"]),
                      spin=jnp.asarray(d["spin"]),
                      types=jnp.asarray(d["types"], jnp.int32),
                      box=jnp.asarray(d["box"]),
                      step=jnp.zeros((d["pos"].shape[0],), jnp.int32))
pot = NEPSpinPotential(spec, params._replace(w2=w2_scale * params.w2),
                       moments=mom)
eng = Engine(potential=pot, cfg=IntegratorConfig(dt=1e-3), state=st,
             masses=jnp.asarray(lat.masses),
             magnetic=jnp.asarray(lat.moments) > 0, field=jnp.asarray(fields),
             plan=Replicated(st.pos.shape[0]),
             observables=("energy", "kinetic", "magnetization"), **run_kw)
out["e0"] = np.asarray(eng.energy)
eng.run(steps, jax.random.PRNGKey(0), chunk=chunk)
out.update({f"obs_{k}": np.asarray(v) for k, v in eng.trace.values.items()})
np.savez(sys.argv[2], n_rebuilds=eng.n_rebuilds,
         pos=np.asarray(eng.state.pos), vel=np.asarray(eng.state.vel),
         spin=np.asarray(eng.state.spin), **out)
"""


def _random_states(cells, seed, temperature=500.0, jitter=0.0):
    lat = b20_fege()
    pos, types, box = lat.supercell(*cells)
    rng = np.random.default_rng(seed)
    m = lat.masses[types]
    out = []
    for _ in range(R):
        sigma = np.sqrt(units.KB * temperature / (m * units.MVV2E))
        vel = sigma[:, None] * rng.standard_normal(pos.shape)
        vel -= vel.mean(axis=0, keepdims=True)
        spin = rng.standard_normal(pos.shape)
        spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
        spin[lat.moments[types] == 0] = 0.0
        p = np.mod(pos + jitter * rng.standard_normal(pos.shape), box)
        out.append(dict(pos=p, vel=vel, spin=spin, types=types, box=box))
    return lat, out


def _stacked(arrays):
    return {k: np.stack([a[k] for a in arrays]) for k in arrays[0]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("replica")
    _, ks = _random_states((2, 2, 2), seed=1, jitter=0.1)
    k = _stacked(ks)
    kst = stack_states([state_from_numpy(**a, dtype=F64, device="cpu")
                        for a in ks])
    from repro_torch.md.neighbor import dense_neighbor_table, reference_pos
    box = kst.box[0]
    tab = dense_neighbor_table(reference_pos(kst.pos, box), box, 5.0, 48)
    _, es = _random_states((3, 3, 3), seed=2)
    e = _stacked(es)
    np.savez(d / "in.npz", k_pos=k["pos"], k_spin=k["spin"],
             k_types=k["types"][0], k_box=k["box"][0],
             k_idx=tab.idx.numpy(), k_mask=tab.mask.numpy(), **e)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), repr((SPEC, FIELDS, RUN, STEPS, CHUNK,
                                   W2_SCALE))],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(d / "out.npz")
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=F64)
    return dict(ref=ref, params=params, kst=kst, table=tab, es=es)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))


def test_batched_kernels_match_vmapped_reference(reference):
    """One batched K1/K2 evaluation (their plain versions on the CPU) of 3
    replicas on a shared table against ``jax.vmap`` of the reference's
    ``nep_compute`` (xla_tiled), f64 within 1e-10."""
    ref, kst = reference["ref"], reference["kst"]
    spec = NEPSpinSpec(**SPEC)
    nbh = shared_blocks(reference["table"], kst.types[0], kst.pos,
                        kst.box[0])
    e, f, h = nep_compute(spec, reference["params"], nbh, kst.spin,
                          kst.types[0], torch.tensor(FIELDS, dtype=F64),
                          torch.tensor([1.16, 0.0], dtype=F64))
    assert e.shape == (R,) and f.shape == kst.pos.shape
    for got, want in ((e, ref["k_e"]), (f, ref["k_f"]), (h, ref["k_h"])):
        assert _rel(got.numpy(), want) < 1e-10


@pytest.fixture(scope="module")
def port_engine(reference):
    lat = b20_fege()
    st = stack_states([state_from_numpy(**a, dtype=F64, device="cpu")
                       for a in reference["es"]])
    params = reference["params"]
    pot = NEPSpinPotential(NEPSpinSpec(**SPEC),
                           params._replace(w2=W2_SCALE * params.w2),
                           torch.tensor([1.16, 0.0], dtype=F64),
                           use_kernel=True)
    eng = Engine(potential=pot, cfg=IntegratorConfig(dt=1e-3), state=st,
                 masses=torch.tensor(lat.masses, dtype=F64),
                 magnetic=torch.tensor(lat.moments) > 0,
                 field=torch.tensor(FIELDS, dtype=F64), plan=Replicated(R),
                 observables=("energy", "kinetic", "magnetization"),
                 device="cpu", **RUN)
    e0 = eng.energy
    eng.run(STEPS, chunk=CHUNK)
    return eng, e0


def test_replica_engine_matches_reference(reference, port_engine):
    """NVE replica Engine (distinct states, a field per replica): the
    shared rebuilds, the initial energies, the observables and the final
    states within 1e-9 of the reference's Replicated Engine."""
    ref = reference["ref"]
    eng, e0 = port_engine
    assert int(ref["n_rebuilds"]) >= 1
    assert eng.n_rebuilds == int(ref["n_rebuilds"])
    assert _rel(e0, ref["e0"]) < 1e-9
    for k, v in eng.trace.values.items():
        assert v.shape == ref[f"obs_{k}"].shape, k
        assert _rel(v, ref[f"obs_{k}"]) < 1e-9, k
    for k in ("pos", "vel", "spin"):
        assert _rel(getattr(eng.state, k).numpy(), ref[k]) < 1e-9, k


def _film(cells=(3, 3, 3), seed=2, temperature=500.0):
    lat = simple_cubic()
    st = init_state(lat, cells, temperature=temperature, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(seed),
                    dtype=F64, device="cpu")
    return (lat, st, torch.tensor(lat.masses, dtype=F64),
            torch.tensor(lat.moments) > 0)


def test_vmapped_replicas_share_in_scan_rebuild():
    """Identical NVE replicas stay bitwise identical through the SHARED
    rebuild and bitwise equal a single fused Simulation (the mean of
    identical replicas is replica 0, so the shared table is the flat
    one)."""
    lat, st, masses, magnetic = _film()
    ham = HeisenbergDMIModel(d0=0.01)
    cfg = IntegratorConfig(dt=2e-3)    # NVE
    ens = ReplicaEnsemble(potential=ham, cfg=cfg, states=replicate(st, 3),
                          masses=masses, magnetic=magnetic, cutoff=5.0,
                          capacity=8, skin=0.2, diag_grid=(3, 3),
                          pitch_bins=3, device="cpu")
    ens.run(60, spawn_generators(9, 3, "cpu"),
            temperature=protocol.constant(0.0), field=np.zeros(3),
            chunk=20)
    for r in (1, 2):
        for k in ("pos", "vel", "spin"):
            assert torch.equal(getattr(ens.states, k)[0],
                               getattr(ens.states, k)[r])
    sim = Simulation(potential=ham, cfg=cfg, state=st, masses=masses,
                     magnetic=magnetic, cutoff=5.0, capacity=8, skin=0.2,
                     field=torch.zeros(3, dtype=F64), device="cpu")
    sim.run(60, chunk=20)
    assert sim.n_rebuilds >= 1
    assert ens._engine.n_rebuilds == sim.n_rebuilds
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(ens.states, k)[0], getattr(sim.state, k))


def _thermo_engine(plan=None, **kw):
    lat, st, masses, magnetic = _film((4, 4, 4), seed=3)
    return Engine(potential=HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=st, masses=masses, magnetic=magnetic, cutoff=5.0,
                  capacity=8, skin=0.2, plan=plan, temperature=100.0,
                  observables=("energy", "kinetic", "magnetization",
                               "charge", "pitch"), device="cpu", **kw)


def _gens(plan, seed):
    return (spawn_generators(seed, plan.replicas, "cpu") if plan is not None
            else torch.Generator().manual_seed(seed))


def test_checkpoint_restart_bitwise_flat_and_replica():
    for plan in (None, Replicated(3)):
        a = _thermo_engine(plan)
        a.run(60, _gens(plan, 5), chunk=20)
        with tempfile.TemporaryDirectory() as d:
            b = _thermo_engine(plan)
            b.run(40, _gens(plan, 5), chunk=20, checkpoint_dir=d)
            c = _thermo_engine(plan)
            gen = c.restore(d)
            c.run(20, gen, chunk=20)
        label = type(plan).__name__ if plan else "flat"
        for k in ("pos", "vel", "spin"):
            assert torch.equal(getattr(a.state, k), getattr(c.state, k)), \
                (label, k)
        assert a.n_rebuilds == c.n_rebuilds, label
        if plan is not None:     # the replicas' own noise streams differ
            assert not torch.equal(a.state.spin[0], a.state.spin[1])


def test_nep_spin_through_replica_plan():
    """NEP-SPIN (autograd, one replica at a time) drives the replica plan
    under a field-cooling schedule."""
    lat = simple_cubic()
    st = init_state(lat, (3, 3, 3), temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(1), device="cpu")
    spec = NEPSpinSpec(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
    params = init_params(spec, torch.Generator().manual_seed(0),
                         device="cpu")
    temp, field = protocol.field_cooling(200.0, 20.0, 5.0, t_hold=0.004,
                                         t_ramp=0.02)
    eng = Engine(potential=NEPSpinPotential(spec, params),
                 cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                      lattice_gamma=1.0),
                 state=st, masses=torch.tensor(lat.masses,
                                               dtype=torch.float32),
                 magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                 capacity=16, skin=0.3, plan=Replicated(2),
                 temperature=temp, field=field,
                 observables=("energy", "charge"), device="cpu")
    eng.run(20, spawn_generators(3, 2, "cpu"), chunk=10)
    assert eng.trace.values["energy"].shape == (2, 2)
    assert np.isfinite(eng.trace.values["energy"]).all()
    assert torch.isfinite(eng.state.spin).all()
    # the replicas' noise streams differ: their trajectories decorrelate
    assert float((eng.state.spin[0] - eng.state.spin[1]).abs().max()) > 0


def test_batch_is_bitwise_flat_engines_with_same_generators():
    """A thermostatted chunk of distinct replicas under per-replica
    temperatures and a field schedule is bitwise R flat Engines run on the
    batch's table with the same generators (both potentials)."""
    lat = b20_fege()
    sts = [init_state(lat, (3, 3, 3), temperature=300.0, dtype=F64,
                      generator=torch.Generator().manual_seed(10 + r),
                      device="cpu") for r in range(R)]
    params = init_params(NEPSpinSpec(**SPEC), torch.Generator().manual_seed(4),
                         dtype=F64, device="cpu")
    pots = (NEPSpinPotential(NEPSpinSpec(**SPEC),
                             params._replace(w2=W2_SCALE * params.w2),
                             torch.tensor([1.16, 0.0], dtype=F64),
                             use_kernel=True),
            HeisenbergDMIModel(r0=2.9, morse_de=0.05, d0=0.008, ka=0.001))
    temps = [100.0, 200.0, 300.0]
    field = protocol.linear(0.0, 0.02, [0.0, 0.0, 0.0], [0.0, 0.0, 2.0])
    kw = dict(cfg=IntegratorConfig(dt=1e-3, lattice_gamma=2.0,
                                   spin_alpha=0.1),
              masses=torch.tensor(lat.masses, dtype=F64),
              magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
              capacity=64, skin=2.0, field=field, device="cpu")
    for pot in pots:
        rep = Engine(pot, state=stack_states(sts), plan=Replicated(R),
                     temperature=temps, **kw)
        table = rep.table
        rep.run(10, spawn_generators(5, R, "cpu"), chunk=5)
        assert rep.n_rebuilds == 0
        gens = spawn_generators(5, R, "cpu")
        for r in range(R):
            flat = Engine(pot, state=sts[r], temperature=temps[r],
                          plan=SingleDevice(cell_order=False), table=table,
                          **kw)
            flat.run(10, gens[r], chunk=5)
            for k in ("pos", "vel", "spin"):
                assert torch.equal(getattr(flat.state, k),
                                   getattr(rep.state, k)[r]), (pot, r, k)
            assert flat.energy == rep.energy[r]
            assert np.array_equal(flat.trace.values["energy"],
                                  rep.trace.values["energy"][:, r])


def _slot_engine(states, table):
    """Per-slot mode on a frozen lattice (the serving layer's packing: no
    rebuild couples the slots), a temperature schedule on each slot's own
    clock."""
    lat = b20_fege()
    params = init_params(NEPSpinSpec(**SPEC), torch.Generator().manual_seed(6),
                         dtype=F64, device="cpu")
    return Engine(NEPSpinPotential(NEPSpinSpec(**SPEC),
                                   params._replace(w2=W2_SCALE * params.w2),
                                   torch.tensor([1.16, 0.0], dtype=F64),
                                   use_kernel=True),
                  IntegratorConfig(dt=1e-3, spin_alpha=0.1,
                                   frozen_lattice=True),
                  states, torch.tensor(lat.masses, dtype=F64),
                  torch.tensor(lat.moments) > 0, 5.0, plan=Replicated(3),
                  per_slot=True,
                  temperature=protocol.linear(0.0, 0.03, 300.0, 50.0),
                  field=(0.0, 0.0, 0.5), capacity=64, skin=0.5,
                  table=table, device="cpu")


def test_seat_vs_backfill_bitwise():
    """Job J seated in slot 1 at engine start, and J written into slot 1 of
    another batch after a chunk (its clock 0, its own generator): J's
    trajectory is bitwise the same, its batch-mates in slots 0 and 2 are
    bitwise those of a run without the write, and the per-slot health
    vectors have one entry per slot."""
    lat = b20_fege()
    jobs = [init_state(lat, (3, 3, 3), temperature=300.0, dtype=F64,
                       generator=torch.Generator().manual_seed(20 + i),
                       device="cpu") for i in range(4)]
    x, y, z, job = jobs
    pos0, _, box = lat.supercell(3, 3, 3)
    from repro_torch.md.neighbor import dense_neighbor_table
    table = dense_neighbor_table(torch.tensor(pos0), torch.tensor(box),
                                 5.0, 64)
    seated = _slot_engine(stack_states([x, job, y]), table)
    seated.run(20, spawn_generators(1, 3, "cpu")[:1] + [
        torch.Generator().manual_seed(99)] + spawn_generators(1, 3,
                                                             "cpu")[2:],
               chunk=10)

    runs = []
    for write in (False, True):
        eng = _slot_engine(stack_states([x, z, y]), table)
        gens = spawn_generators(2, 3, "cpu")
        eng.run(10, gens, chunk=10)
        if write:
            eng.write_slots([1], stack_states([job]))
            gens[1] = torch.Generator().manual_seed(99)
        eng.run(20, gens, chunk=10)
        runs.append(eng)
    plain, backfilled = runs
    assert backfilled.state.step.tolist() == [30, 20, 30]
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(backfilled.state, k)[1],
                           getattr(seated.state, k)[1]), k
        for s in (0, 2):
            assert torch.equal(getattr(backfilled.state, k)[s],
                               getattr(plain.state, k)[s]), (k, s)
    h = backfilled.trace.health
    for k in ("slot_nonfinite", "slot_e_drift", "slot_spin_dev"):
        assert h[k].shape == (2, 3), k
    assert backfilled.n_rebuilds == 0


def test_plan_errors():
    lat, st, masses, magnetic = _film()
    ham = HeisenbergDMIModel()
    kw = dict(cfg=IntegratorConfig(), masses=masses, magnetic=magnetic,
              cutoff=5.0, capacity=8, device="cpu")
    with pytest.raises(ValueError, match="per_slot"):
        Engine(ham, state=st, per_slot=True, **kw)
    with pytest.raises(ValueError, match="batch"):
        Engine(ham, state=replicate(st, 2), plan=Replicated(3), **kw)
    # devices are a DeviceMesh or ranks; more than one rank needs a group
    with pytest.raises(ValueError, match="ranks"):
        Engine(ham, state=st, plan=Replicated(2, devices=("a", "b")), **kw)
    with pytest.raises(ValueError, match="process group"):
        Engine(ham, state=st, plan=Replicated(2, devices=(0, 1)), **kw)
    eng = Engine(ham, state=st, plan=Replicated(2), **kw)
    assert eng.state.pos.shape[0] == 2 and eng.shard_replicas() is eng
    with pytest.raises(ValueError, match="one generator per replica"):
        eng.run(2, [torch.Generator()], temperature=10.0)
    with pytest.raises(ValueError, match="SlotSchedules"):
        eng.run(2, spawn_generators(0, 2, "cpu"),
                temperature=protocol.stack_schedules(
                    [protocol.constant(1.0), protocol.constant(2.0)]))
    row = unstack_state(eng.state, 1)
    assert row.pos.shape == st.pos.shape and row.step == 0
