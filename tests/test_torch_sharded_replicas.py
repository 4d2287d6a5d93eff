"""The port's replicas x domain plan and its replica axis across ranks,
against the JAX package's, on gloo ranks.

One f64 JAX subprocess with 4 forced host devices runs, once per module:

* ``jax.vmap`` of the reference's ``nep_compute`` (``mode="xla_tiled"``)
  over 2 replicas of a jittered B20 2x2x2 crystal, each with its own table
  and types (the Sharded plan's per-replica tables), and ``jax.vmap`` of
  the reference's K2 on 2 replicas' adjoint rows past their atoms
  (``abar`` (R, n_src > N, A), the gathered form);
* ``tests/test_domain_loop.py``'s replica case: simple cubic 8x8x8 at 400 K
  with random spins, Heisenberg-DMI at B = 0.5 T, ``SimulationSharded``
  with ``replicas=2`` on a 2x2 ``("replica", "sx")`` mesh, 20 NVE steps
  (T = 0 per replica);
* NEP-SPIN through the kernels (``use_kernel=True``) on ``Sharded(replicas=
  2)`` over ``("sx",)`` x 2, a field per replica, 20 NVE steps.

The port runs the same numbers at f64 on the CPU (K1/K2's plain versions):
the kernels within 1e-10; on 4 gloo ranks the replica case (replicas
identical, each within 1e-12 of an unreplicated one-rank run, trace shapes
(2, 2) and (2, 2, 3), positions within 1e-9 of the reference's); on 2 gloo
ranks the NEP-SPIN case within 1e-9 of the reference's, and
``Replicated(4)`` split over the 2 ranks bitwise the one-process
``Replicated(4)``, through a resume and through a tempering run.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.core.potential import NEPSpinPotential, params_from_jax
from repro_torch.ensemble import protocol
from repro_torch.kernels.nep.ref import atom_pass_plain, force_pass_plain
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.state import state_from_numpy
from repro_torch.parallel.plan import Replicated, Sharded
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
RUN = dict(cutoff=5.0, capacity=32, skin=0.2)
FIELD_B = (0.0, 0.0, 0.5)
NEP_FIELDS = [(0.0, 0.0, 0.5), (0.0, 0.3, 0.1)]
STEPS, CHUNK = 20, 10

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
jax.config.update("jax_enable_x64", True)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.descriptor import NEPSpinSpec
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.core.potential import NEPSpinPotential, init_params
from repro.kernels.nep.kernel import acc_keys, acc_tails, nep_force_pass
from repro.kernels.nep.ops import nep_compute
from repro.md.integrator import IntegratorConfig
from repro.md.lattice import simple_cubic
from repro.md.neighbor import Neighborhood
from repro.md.simulate import SimulationSharded
from repro.md.state import init_state

spec_kw, run, steps, chunk, field_b, nep_fields = eval(sys.argv[3])
d = dict(np.load(sys.argv[1]))
spec = NEPSpinSpec(**spec_kw)
params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
out = {f"param_{i}": np.asarray(x) for i, x in enumerate(params)}
mom = jnp.asarray([1.16, 0.0])

# K1/K2 on per-replica tables, vmapped
def one(dr, mask, idx, tj, spin, types):
    nbh = Neighborhood(idx=idx, mask=mask, tj=tj, dr=dr)
    return nep_compute(spec, params, nbh, spin, types, None, mom,
                       mode="xla_tiled")
e, f, h = jax.vmap(one)(*(jnp.asarray(d[f"k_{k}"]) for k in
                          ("dr", "mask", "idx", "tj", "spin", "types")))
out.update(k_e=np.asarray(e), k_f=np.asarray(f), k_h=np.asarray(h))

# K2 on adjoint rows past the atoms, per replica
tails = acc_tails(spec)
def unpack(flat):
    o, u = 0, {}
    for k in acc_keys(spec):
        w = int(np.prod(tails[k]))
        u[k] = flat[..., o:o + w].reshape(flat.shape[:-1] + tails[k])
        o += w
    return u
n = d["g_dr"].shape[1]
def k2(dr, mask, ti, tj, si, sj, idx, abar):
    return nep_force_pass(spec, params, dr, mask, ti, tj, si, sj,
                          unpack(abar[:n]), unpack(abar[idx]),
                          mode="xla_tiled")
f2, h2 = jax.vmap(k2)(*(jnp.asarray(d[f"g_{k}"]) for k in
                        ("dr", "mask", "ti", "tj", "si", "sj", "idx",
                         "abar")))
out.update(g_f=np.asarray(f2), g_h2=np.asarray(h2))

# the replica axis on the spatial mesh (tests/test_domain_loop.py)
lat = simple_cubic()
kw = dict(masses=jnp.asarray(lat.masses),
          magnetic=jnp.asarray(lat.moments) > 0, **run)
st = init_state(lat, (8, 8, 8), temperature=400.0, spin_init="random",
                key=jax.random.PRNGKey(7))
out.update({k: np.asarray(getattr(st, k))
            for k in ("pos", "vel", "spin", "types", "box")})
devs = np.asarray(jax.devices())
meshr = Mesh(devs.reshape(2, 2), ("replica", "sx"))
shr = SimulationSharded(potential=HeisenbergDMIModel(d0=0.008),
                        cfg=IntegratorConfig(dt=2e-3), state=st, mesh=meshr,
                        axis_map=("sx", None, None),
                        field=jnp.asarray(field_b), replicas=2, **kw)
shr.run(steps, jax.random.PRNGKey(3), chunk=chunk, temperature=jnp.zeros(2))
out["rep_pos"] = np.asarray(shr.state.pos)
out["rep_energy"] = np.asarray(shr.trace.energy)

# NEP-SPIN through the kernels, replicas on a 1-D mesh
mesh2 = Mesh(devs[:2], ("sx",))
nep = SimulationSharded(potential=NEPSpinPotential(spec, params, moments=mom,
                                                   use_kernel=True),
                        cfg=IntegratorConfig(dt=2e-3), state=st, mesh=mesh2,
                        axis_map=("sx", None, None),
                        field=jnp.asarray(nep_fields), replicas=2, **kw)
nep.run(steps, jax.random.PRNGKey(3), chunk=chunk, temperature=jnp.zeros(2))
for k in ("pos", "vel", "spin"):
    out[f"nep_{k}"] = np.asarray(getattr(nep.state, k))
out["nep_rebuilds"] = np.asarray(nep.n_rebuilds)
np.savez(sys.argv[2], **out)
"""


def _kernel_inputs(rng):
    """Per-replica-table K1/K2 inputs (the ``k_`` set: a table each, from
    jittered B20 2x2x2 positions) and K2's gathered-form inputs with
    ``n_src > N`` adjoint rows per replica (the ``g_`` set)."""
    from repro_torch.kernels.nep.layout import acc_width
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.neighbor import dense_neighbor_table
    lat = b20_fege()
    pos, _, box = lat.supercell(2, 2, 2)
    n, m = pos.shape[0], 48
    k = {name: [] for name in ("dr", "mask", "idx", "tj", "spin", "types")}
    for _ in range(2):
        p = np.mod(pos + 0.1 * rng.standard_normal(pos.shape), box)
        types = rng.integers(0, 2, n).astype(np.int32)
        tab = dense_neighbor_table(torch.from_numpy(p), torch.from_numpy(box),
                                   5.0, m)
        idx, mask = tab.idx.numpy(), tab.mask.numpy()
        dr = p[idx] - p[:, None, :]
        dr -= box * np.round(dr / box)
        spin = rng.standard_normal((n, 3))
        for name, v in (("dr", dr), ("mask", mask), ("idx", idx),
                        ("tj", types[idx]), ("spin", spin),
                        ("types", types)):
            k[name].append(v)
    out = {f"k_{name}": np.stack(v) for name, v in k.items()}
    n, m, n_src = 64, 8, 150
    width = acc_width(NEPSpinSpec(**SPEC))
    dr = rng.normal(size=(2, n, m, 3)) * 1.5
    dr[..., 0] += 2.0
    out.update(g_dr=dr, g_mask=rng.random((2, n, m)) < 0.8,
               g_ti=rng.integers(0, 2, (2, n)).astype(np.int32),
               g_tj=rng.integers(0, 2, (2, n, m)).astype(np.int32),
               g_si=rng.normal(size=(2, n, 3)),
               g_sj=rng.normal(size=(2, n, m, 3)),
               g_idx=rng.integers(0, n_src, (2, n, m)).astype(np.int32),
               g_abar=rng.normal(size=(2, n_src, width)))
    return out


def _inputs(d):
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    lat = simple_cubic()
    st = state_from_numpy(*(ref[k] for k in ("pos", "vel", "spin", "types",
                                             "box")), dtype=F64, device="cpu")
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=F64)
    kw = dict(masses=torch.tensor(lat.masses, dtype=F64),
              magnetic=torch.tensor(lat.moments) > 0, device="cpu", **RUN)
    return ref, st, params, kw


def _replica_mesh_rank(rank, d):
    """The reference's replica case on a 2x2 ("replica", "sx") mesh."""
    from repro_torch.ensemble.replica import sharded_replica_mesh
    from repro_torch.md.simulate import SimulationSharded
    torch.set_num_threads(1)
    _, st, _, kw = _inputs(d)
    kw.pop("device")
    sim = SimulationSharded(HeisenbergDMIModel(d0=0.008),
                            IntegratorConfig(dt=2e-3), st,
                            mesh=sharded_replica_mesh(2, 2),
                            axis_map=("sx", None, None), field=FIELD_B,
                            replicas=2, device="cpu", **kw)
    eng = sim._engine
    assert eng._batch == 1 and eng._rplan.rep_in_mesh()
    sim.run(STEPS, [torch.Generator().manual_seed(3)], chunk=CHUNK,
            temperature=np.zeros(2))
    if rank == 0:
        np.savez(os.path.join(d, "port_rep.npz"), pos=sim.state.pos.numpy(),
                 spin=sim.state.spin.numpy(), energy=sim.trace.energy,
                 magnetization=sim.trace.magnetization)


def _replicated_run(kw, st, devices, d, tag, rank):
    """Replicated(4) under a thermostat: 10 steps, a checkpoint, a fresh
    Engine restored from it runs 10 more; then a tempering run of the
    ensemble facade.  Split over the ranks ``devices`` (None: one
    process)."""
    from repro_torch.ensemble.replica import ReplicaEnsemble, replicate
    pot = HeisenbergDMIModel(d0=0.008)
    cfg = IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.05)
    own = slice(0, 4) if devices is None else slice(2 * rank, 2 * rank + 2)

    def gens(seed):
        return [torch.Generator().manual_seed(seed + r)
                for r in range(4)][own]

    def engine():
        return Engine(pot, cfg, st, plan=Replicated(4, devices=devices),
                      temperature=[100.0, 200.0, 300.0, 400.0],
                      field=FIELD_B, observables=("energy", "magnetization"),
                      **kw)

    ck = os.path.join(d, f"ck_{tag}")
    a = engine()
    a.run(10, gens(10), chunk=10, checkpoint_dir=ck)
    b = engine()
    g = b.restore(ck)
    b.run(10, g, chunk=10)
    ens = ReplicaEnsemble(pot, cfg, replicate(st, 4), kw["masses"],
                          kw["magnetic"], 5.0, capacity=32, skin=0.2,
                          device="cpu")
    if devices is not None:
        ens.shard(devices)
    tr = ens.run(30, gens(20), temperature=np.asarray([100.0, 200.0, 300.0,
                                                       400.0]),
                 chunk=5, exchange_every=1,
                 exchange_generator=torch.Generator().manual_seed(4))
    return {"pos": b.state.pos.numpy(), "vel": b.state.vel.numpy(),
            "spin": b.state.spin.numpy(), "energy": b.trace.values["energy"],
            "rebuilds": b.n_rebuilds, "t_pos": ens.states.pos.numpy(),
            "t_vel": ens.states.vel.numpy(), "t_energy": tr.energy,
            "t_accepts": tr.exchange_accepts}


def _two_ranks(rank, d):
    """NEP-SPIN through the kernels on Sharded(replicas=2), and
    Replicated(4) split over the two ranks."""
    torch.set_num_threads(1)
    ref, st, params, kw = _inputs(d)
    pot = NEPSpinPotential(NEPSpinSpec(**SPEC), params,
                           torch.tensor([1.16, 0.0], dtype=F64),
                           use_kernel=True)
    eng = Engine(pot, IntegratorConfig(dt=2e-3), st,
                 plan=Sharded(replicas=2), field=np.asarray(NEP_FIELDS),
                 **kw)
    eng.run(STEPS, [torch.Generator(), torch.Generator()], chunk=CHUNK,
            temperature=np.zeros(2))
    rep = _replicated_run(kw, st, (0, 1), d, "split", rank)
    if rank == 0:
        np.savez(os.path.join(d, "port_nep.npz"),
                 **{k: getattr(eng.state, k).numpy()
                    for k in ("pos", "vel", "spin")},
                 rebuilds=eng.n_rebuilds, migrated=eng.n_migrated,
                 e_shape=np.asarray(eng.trace.values["energy"].shape))
        np.savez(os.path.join(d, "port_split.npz"), **rep)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.parallel.ranks import spawn
    d = str(tmp_path_factory.mktemp("sharded_replicas"))
    kin = _kernel_inputs(np.random.default_rng(5))
    np.savez(os.path.join(d, "in.npz"), **kin)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, os.path.join(d, "in.npz"),
         os.path.join(d, "ref.npz"),
         repr((SPEC, RUN, STEPS, CHUNK, FIELD_B, NEP_FIELDS))],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    spawn(_replica_mesh_rank, 4, d, workdir=d)
    spawn(_two_ranks, 2, d, workdir=d)
    ref, st, params, kw = _inputs(d)
    one = Engine(HeisenbergDMIModel(d0=0.008), IntegratorConfig(dt=2e-3), st,
                 plan=Sharded(), field=FIELD_B, **kw)
    one.run(STEPS, torch.Generator(), chunk=CHUNK, temperature=0.0)
    return dict(ref=ref, kin=kin, params=params, one=one.state,
                rep=dict(np.load(os.path.join(d, "port_rep.npz"))),
                nep=dict(np.load(os.path.join(d, "port_nep.npz"))),
                split=dict(np.load(os.path.join(d, "port_split.npz"))),
                whole=_replicated_run(kw, st, None, d, "whole", 0))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0))


def test_kernels_on_per_replica_tables_match_vmapped_reference(runs):
    """K1 then K2 (plain versions) on 2 replicas, each with its own table
    and types (mask, tj, idx (R, N, M), ti (R, N)), against ``jax.vmap`` of
    the reference's ``nep_compute``: E, F and H_eff within 1e-10."""
    k, ref = runs["kin"], runs["ref"]
    spec, params = NEPSpinSpec(**SPEC), runs["params"]
    t = {name: torch.from_numpy(v) for name, v in k.items()}
    sj = torch.stack([t["k_spin"][r][t["k_idx"][r].long()]
                      for r in range(2)])
    args = (t["k_dr"], t["k_mask"], t["k_types"], t["k_tj"], t["k_spin"], sj)
    e, hdir, abar = atom_pass_plain(spec, params, *args)
    f, h2 = force_pass_plain(spec, params, t["k_dr"], t["k_mask"],
                             t["k_idx"], t["k_types"], t["k_tj"],
                             t["k_spin"], sj, abar)
    assert e.shape == (2, k["k_dr"].shape[1]) and f.shape == t["k_spin"].shape
    assert _rel(e.sum(dim=1), ref["k_e"]) < 1e-10
    assert _rel(f, ref["k_f"]) < 1e-10
    assert _rel(hdir + h2, ref["k_h"]) < 1e-10
    # a per-replica-table launch is replica r's flat launch, exactly
    e1, _, _ = atom_pass_plain(spec, params, *(x[1] for x in args))
    assert torch.equal(e1, e[1])


def test_k2_on_per_replica_abar_rows_past_the_atoms(runs):
    """K2's plain version with ``abar`` (R, n_src > N, A) and per-replica
    tables against ``jax.vmap`` of the reference's K2 on the gathered
    (abar_i, abar_j) form, within 1e-10."""
    k, ref = runs["kin"], runs["ref"]
    t = {name: torch.from_numpy(v) for name, v in k.items()}
    f, h2 = force_pass_plain(NEPSpinSpec(**SPEC), runs["params"], t["g_dr"],
                             t["g_mask"], t["g_idx"], t["g_ti"], t["g_tj"],
                             t["g_si"], t["g_sj"], t["g_abar"])
    assert t["g_abar"].shape[1] > t["g_dr"].shape[1]
    assert _rel(f, ref["g_f"]) < 1e-10 and _rel(h2, ref["g_h2"]) < 1e-10


def test_replicas_on_the_spatial_mesh_match_reference(runs):
    """tests/test_domain_loop.py's replica case on a 2x2 ("replica", "sx")
    mesh of 4 gloo ranks: NVE replicas stay identical, each tracks an
    unreplicated one-rank run, the trace is (C, R) and (C, R, 3), and the
    positions are the reference's."""
    rep, ref = runs["rep"], runs["ref"]
    assert np.abs(rep["pos"][0] - rep["pos"][1]).max() == 0.0
    assert np.abs(rep["spin"][0] - rep["spin"][1]).max() == 0.0
    assert np.abs(rep["pos"][0] - runs["one"].pos.numpy()).max() < 1e-12
    assert rep["energy"].shape == (2, 2)
    assert rep["magnetization"].shape == (2, 2, 3)
    assert np.abs(rep["pos"] - ref["rep_pos"]).max() < 1e-9
    assert np.abs(rep["energy"] - ref["rep_energy"]).max() < 1e-9


def test_nep_kernel_replicas_match_reference(runs):
    """NEP-SPIN through K1/K2 (plain versions) on Sharded(replicas=2) over
    2 gloo ranks, a field per replica: pos, vel and spin within 1e-9 of the
    reference's, with its rebuild count."""
    nep, ref = runs["nep"], runs["ref"]
    assert int(nep["rebuilds"]) == int(ref["nep_rebuilds"]) >= 1
    assert int(nep["migrated"]) > 0 and tuple(nep["e_shape"]) == (2, 2)
    for k in ("pos", "vel", "spin"):
        assert np.abs(nep[k] - ref[f"nep_{k}"]).max() < 1e-9, k
    assert np.abs(nep["pos"][0] - nep["pos"][1]).max() > 0.0


@pytest.mark.parametrize("part", ["resume", "tempering"])
def test_replicated_split_over_ranks_is_bitwise(runs, part):
    """Replicated(4) split over 2 gloo ranks (2 replicas and generators
    each) is bitwise the one-process Replicated(4): through a checkpoint
    restored into a fresh Engine, and through a tempering run (the swaps
    made on every rank alike)."""
    split, whole = runs["split"], runs["whole"]
    keys = (("pos", "vel", "spin", "energy") if part == "resume"
            else ("t_pos", "t_vel", "t_energy"))
    for k in keys:
        assert np.array_equal(split[k], whole[k]), k
    if part == "resume":
        assert int(split["rebuilds"]) == whole["rebuilds"]
    else:
        assert int(split["t_accepts"]) == whole["t_accepts"]


def test_run_sharded_sweep_on_one_rank():
    """``run_sharded_sweep`` runs a (T, B) sweep as one Sharded Engine
    with a replica per point (one rank, no process group: every replica
    local): a (C, R) trace, each replica at its own temperature, the
    replicas apart."""
    from repro_torch.ensemble.replica import run_sharded_sweep
    from repro_torch.md.state import init_state
    lat = simple_cubic()
    st = init_state(lat, (6, 6, 6), temperature=100.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(4), dtype=F64,
                    device="cpu")
    eng, tr = run_sharded_sweep(
        HeisenbergDMIModel(d0=0.01),
        IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.05), st,
        torch.tensor(lat.masses, dtype=F64), torch.tensor(lat.moments) > 0,
        5.0, [50.0, 400.0], [(0.0, 0.0, 0.0), (0.0, 0.0, 1.0)], n_steps=20,
        chunk=10, capacity=32, skin=0.2, device="cpu")
    assert eng.replicas == 2 and eng._batch == 2
    assert tr.values["energy"].shape == (2, 2)
    assert tr.values["magnetization"].shape == (2, 2, 3)
    assert np.isfinite(tr.values["kinetic"]).all()
    assert tr.values["kinetic"][-1, 1] > tr.values["kinetic"][-1, 0]
    with pytest.raises(ValueError, match="replica count"):
        run_sharded_sweep(None, None, st, None, None, 5.0,
                          protocol.constant(10.0))
    # the reference's limits of the replicas x domain plan
    with pytest.raises(NotImplementedError, match="single-trajectory"):
        eng.restore("unused", plan=Sharded())
    with pytest.raises(NotImplementedError, match="replicated-sharded"):
        eng.rebind(plan=Sharded(replicas=2, cell_capacity=40))
