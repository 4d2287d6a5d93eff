"""The port's Sharded plan against the JAX package's, on gloo ranks.

One f64 JAX subprocess with 4 forced host devices (as
``tests/test_domain_loop.py`` runs it) drives the reference's
``SimulationSharded`` from simple cubic 8x8x8 at 400 K with random spins
(cutoff 5, capacity 32, skin 0.2, chunk 10) in three cases:

* Heisenberg-DMI, midpoint with 2 iterations, on ``("sx",)`` x 2, 30 steps;
* autograd NEP-SPIN on ``("sx", "sy")`` 2x2, 20 steps;
* NEP-SPIN through the kernels (``use_kernel=True``) on ``("sx",)`` x 2, 20
  steps;

and the reference's K2 on neighbour adjoint rows past the owned ones (the
gathered form).  It saves the initial state, the weights and its results.

The port's ranks start from those arrays: ``torch.multiprocessing`` spawns
2 ranks (the Heisenberg-DMI and kernel cases, the halo functions, a
same-mesh resume) and 4 ranks (the autograd case on a 2x2 DeviceMesh, the
halo functions) under gloo with a ``file://`` rendezvous, each group once.
On the CPU the kernel case runs K1/K2's plain versions.  The port holds:
final pos, vel and spin within 1e-9 of the reference's sharded run and of
the port's flat Engine; at construction E within 1e-10 and F, H_eff within
1e-11 of the flat evaluation; >= 1 rebuild with migrations; exactly one
drift-pos exchange per step; ``exchange_halo`` / ``fold_halo`` (both halo
modes) against ``np.pad(..., mode="wrap")`` of the global array and its
scatter-add adjoint; a resume bitwise the uninterrupted run.  Also: the
5-atom migration overflow (2 dropped, 3 survivors), ``_check_dropped``
raising ``HealthError(kind="overflow")``, the one-rank plan (no process
group) against the flat Engine, K2's plain version on an ``abar`` of more
rows than atoms against the reference's gathered form, the plan's errors,
``SimulationSharded``, and ``launch/md_step.py`` on 2 ranks in ppermute
mode (the Engine's exchanges as ``batch_isend_irecv``) against the flat
Engine.
"""
import json
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
from repro_torch.kernels.nep.ref import force_pass_plain
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.state import state_from_numpy
from repro_torch.parallel.plan import Sharded, as_plan
from repro_torch.telemetry import HealthError
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
RUN = dict(cutoff=5.0, capacity=32, skin=0.2)
CHUNK = 10
# case -> (integrator config, steps, mesh dims of the reference and port)
CASES = {"heisenberg": (dict(dt=2e-3, midpoint=True, midpoint_iters=2), 30,
                        ("sx",)),
         "nep": (dict(dt=2e-3), 20, ("sx", "sy")),
         "nep_kernel": (dict(dt=2e-3), 20, ("sx",))}

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
from repro.md.integrator import IntegratorConfig
from repro.md.lattice import simple_cubic
from repro.md.simulate import SimulationSharded
from repro.md.state import init_state

spec_kw, run, chunk, cases = eval(sys.argv[2])
lat = simple_cubic()
kw = dict(masses=jnp.asarray(lat.masses),
          magnetic=jnp.asarray(lat.moments) > 0, **run)
st = init_state(lat, (8, 8, 8), temperature=400.0, spin_init="random",
                key=jax.random.PRNGKey(7))
out = {k: np.asarray(getattr(st, k))
       for k in ("pos", "vel", "spin", "types", "box")}
spec = NEPSpinSpec(**spec_kw)
params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
out.update({f"param_{i}": np.asarray(x) for i, x in enumerate(params)})
devs = np.asarray(jax.devices())
pots = {"heisenberg": HeisenbergDMIModel(d0=0.008, ka=0.001),
        "nep": NEPSpinPotential(spec, params, use_kernel=False),
        "nep_kernel": NEPSpinPotential(spec, params, use_kernel=True)}
for name, (cfg, steps, dims) in cases.items():
    n = 2 ** len(dims)
    mesh = Mesh(devs[:n].reshape((2,) * len(dims)), dims)
    axis_map = tuple(list(dims) + [None] * (3 - len(dims)))
    sh = SimulationSharded(potential=pots[name], cfg=IntegratorConfig(**cfg),
                           state=st, mesh=mesh, axis_map=axis_map, **kw)
    sh.run(steps, jax.random.PRNGKey(1), chunk=chunk)
    for k in ("pos", "vel", "spin"):
        out[f"{name}_{k}"] = np.asarray(getattr(sh.state, k))
    out[f"{name}_rebuilds"] = np.asarray(sh.n_rebuilds)
    out[f"{name}_migrated"] = np.asarray(sh.n_migrated)

# K2 on neighbour adjoint rows past the owned ones, in the gathered form
rng = np.random.default_rng(3)
n, m, n_src = 64, 8, 150
tails = acc_tails(spec)
width = sum(int(np.prod(t)) for t in tails.values())
dr = rng.normal(size=(n, m, 3)) * 1.5
dr[..., 0] += 2.0
k2 = dict(dr=dr, mask=rng.random((n, m)) < 0.8,
          ti=rng.integers(0, 2, n).astype(np.int32),
          tj=rng.integers(0, 2, (n, m)).astype(np.int32),
          si=rng.normal(size=(n, 3)), sj=rng.normal(size=(n, m, 3)),
          idx=rng.integers(0, n_src, (n, m)).astype(np.int32),
          abar=rng.normal(size=(n_src, width)))

def unpack(flat):
    o, d = 0, {}
    for k in acc_keys(spec):
        w = int(np.prod(tails[k]))
        d[k] = jnp.asarray(flat[..., o:o + w].reshape(flat.shape[:-1]
                                                      + tails[k]))
        o += w
    return d

f, h2 = nep_force_pass(spec, params, *(jnp.asarray(k2[k]) for k in
                       ("dr", "mask", "ti", "tj", "si", "sj")),
                       unpack(k2["abar"][:n]), unpack(k2["abar"][k2["idx"]]),
                       mode="xla_tiled")
out.update({f"k2_{k}": v for k, v in k2.items()})
out.update(k2_f=np.asarray(f), k2_h2=np.asarray(h2))
np.savez(sys.argv[1], **out)
"""


def _inputs(d):
    """The reference's initial state, lattice arrays and potentials, at
    f64 on the CPU."""
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    lat = simple_cubic()
    st = state_from_numpy(*(ref[k] for k in ("pos", "vel", "spin", "types",
                                             "box")), dtype=F64, device="cpu")
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=F64)
    spec = NEPSpinSpec(**SPEC)
    pots = {"heisenberg": HeisenbergDMIModel(d0=0.008, ka=0.001),
            "nep": NEPSpinPotential(spec, params),
            "nep_kernel": NEPSpinPotential(spec, params, use_kernel=True)}
    kw = dict(masses=torch.tensor(lat.masses, dtype=F64),
              magnetic=torch.tensor(lat.moments) > 0, device="cpu", **RUN)
    return ref, st, pots, kw


def _mesh(dims):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2,) * len(dims), mesh_dim_names=dims)


def _sharded_case(name, d, mesh):
    """Run one case on this rank; rank 0 saves what the tests read."""
    import torch.distributed as dist
    _, st, pots, kw = _inputs(d)
    cfg, steps, _ = CASES[name]
    eng = Engine(pots[name], IntegratorConfig(**cfg), st,
                 plan=Sharded(mesh=mesh), **kw)
    init = {"e0": np.asarray(eng.energy), "f0": eng._ff.force.numpy(),
            "h0": eng._ff.field.numpy()}
    before = eng.halo_ledger.counts.get("drift-pos", 0)
    eng.run(steps, chunk=CHUNK)
    if dist.get_rank() == 0:
        np.savez(os.path.join(d, f"port_{name}.npz"), **init,
                 **{k: getattr(eng.state, k).numpy()
                    for k in ("pos", "vel", "spin")},
                 rebuilds=eng.n_rebuilds, migrated=eng.n_migrated,
                 drift=eng.halo_ledger.counts["drift-pos"] - before,
                 steps=steps, allgather=eng._rplan.allgather)


def _halo_errors(mesh, axis_map, seed):
    """Max errors of exchange_halo(_multi) and fold_halo on this rank, both
    halo modes, against numpy on the global array."""
    from repro_torch.parallel.halo import (exchange_halo,
                                           exchange_halo_multi, fold_halo,
                                           fold_halo_multi, halo_axes)
    axes = halo_axes(mesh, axis_map)
    glob = (4, 6, 3)
    local = tuple(g // (ax.size if ax else 1) for g, ax in zip(glob, axes))
    off = [ax.index * c if ax else 0 for ax, c in zip(axes, local)]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=glob + (2, 3))
    ids = rng.integers(-1, 1 << 20, glob + (2,)).astype(np.int32)

    def mine(a, ext=0):
        return a[tuple(slice(o, o + c + 2 * ext)
                       for o, c in zip(off, local))]

    want = mine(np.pad(x, [(1, 1)] * 3 + [(0, 0)] * 2, mode="wrap"), 1)
    ids_want = mine(np.pad(ids, [(1, 1)] * 3 + [(0, 0)], mode="wrap"), 1)
    ids_l = torch.from_numpy(mine(ids).copy())
    xl = torch.from_numpy(mine(x).copy())
    # every rank's ghost-extended contributions, folded in numpy
    ranks = [(i, j) for i in range(glob[0] // local[0])
             for j in range(glob[1] // local[1])]
    ys = {r: rng.normal(size=tuple(c + 2 for c in local) + (2, 3))
          for r in ranks}
    folded = np.zeros_like(x)
    for (i, j), y in ys.items():
        ix = np.arange(i * local[0] - 1, (i + 1) * local[0] + 1) % glob[0]
        iy = np.arange(j * local[1] - 1, (j + 1) * local[1] + 1) % glob[1]
        iz = np.arange(-1, local[2] + 1) % glob[2]
        np.add.at(folded, np.ix_(ix, iy, iz), y)
    me = (off[0] // local[0], off[1] // local[1])
    fwant = folded[off[0]:off[0] + local[0], off[1]:off[1] + local[1]]
    errs = {}
    for mode in (False, True):
        tag = "allgather" if mode else "ppermute"
        got = exchange_halo(xl, axes, allgather=mode).numpy()
        errs[f"exchange_{tag}"] = float(np.abs(got - want).max())
        ext = exchange_halo_multi({"x": xl, "ids": ids_l}, axes,
                                  allgather=mode)
        errs[f"multi_{tag}"] = float(np.abs(ext["x"].numpy() - want).max())
        errs[f"multi_ids_{tag}"] = float(
            np.abs(ext["ids"].numpy() - ids_want).max()
            + (ext["ids"].dtype != torch.int32))
        y = torch.from_numpy(ys[me].copy())
        got = fold_halo(y, axes, allgather=mode).numpy()
        errs[f"fold_{tag}"] = float(np.abs(got - fwant).max())
        got = fold_halo_multi({"a": y[..., :1], "b": y[..., 1:]}, axes,
                              allgather=mode)
        errs[f"fold_multi_{tag}"] = float(np.abs(
            torch.cat([got["a"], got["b"]], -1).numpy() - fwant).max())
    return errs


def _max_over_ranks(errs: dict) -> dict:
    import torch.distributed as dist
    vec = torch.tensor([errs[k] for k in sorted(errs)], dtype=F64)
    dist.all_reduce(vec, op=dist.ReduceOp.MAX)
    return dict(zip(sorted(errs), vec.tolist()))


def _resume_case(d):
    """A thermostatted run interrupted at chunk 1 and resumed in a fresh
    Engine, each rank with its own generator."""
    import torch.distributed as dist
    _, st, _, kw = _inputs(d)
    rank = dist.get_rank()
    cfg = IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.05)
    ck = os.path.join(d, "ck")

    def engine():
        return Engine(HeisenbergDMIModel(d0=0.008), cfg, st, plan=Sharded(),
                      temperature=300.0, field=(0.0, 0.0, 0.5), **kw)

    whole = engine()
    whole.run(20, torch.Generator().manual_seed(5 + rank), chunk=CHUNK,
              checkpoint_dir=ck)
    resumed = engine()
    gen = resumed.restore(ck, step=CHUNK)
    resumed.run(CHUNK, gen, chunk=CHUNK)
    same = all(torch.equal(getattr(whole.state, k), getattr(resumed.state, k))
               for k in ("pos", "vel", "spin"))
    same = same and torch.equal(whole._ff.force, resumed._ff.force)
    flag = torch.tensor([float(same), float(resumed.n_rebuilds
                                            == whole.n_rebuilds)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return {"bitwise": flag[0].item(), "rebuilds_equal": flag[1].item(),
            "rebuilds": whole.n_rebuilds}


def _two_ranks(rank, d):
    torch.set_num_threads(1)
    mesh = _mesh(("sx",))
    for name in ("heisenberg", "nep_kernel"):
        _sharded_case(name, d, mesh)
    res = {"halo": _max_over_ranks(_halo_errors(mesh, ("sx", None, None), 11)),
           "resume": _resume_case(d)}
    if rank == 0:
        with open(os.path.join(d, "two.json"), "w") as f:
            json.dump(res, f)


def _four_ranks(rank, d):
    torch.set_num_threads(1)
    mesh = _mesh(("sx", "sy"))
    _sharded_case("nep", d, mesh)
    res = {"halo": _max_over_ranks(_halo_errors(mesh, ("sx", "sy", None),
                                                12))}
    if rank == 0:
        with open(os.path.join(d, "four.json"), "w") as f:
            json.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.parallel.ranks import spawn
    d = str(tmp_path_factory.mktemp("sharded"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, os.path.join(d, "ref.npz"),
         repr((SPEC, RUN, CHUNK, CASES))],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    spawn(_two_ranks, 2, d, workdir=d)
    spawn(_four_ranks, 4, d, workdir=d)
    ref, st, pots, kw = _inputs(d)
    flat = {}
    for name, (cfg, steps, _) in CASES.items():
        eng = Engine(pots[name], IntegratorConfig(**cfg), st, **kw)
        init = (eng.energy, eng._ff.force.clone(), eng._ff.field.clone())
        eng.run(steps, chunk=CHUNK)
        flat[name] = (init, eng.state, eng.n_rebuilds)
    port = {name: dict(np.load(os.path.join(d, f"port_{name}.npz")))
            for name in CASES}
    with open(os.path.join(d, "two.json")) as f:
        two = json.load(f)
    with open(os.path.join(d, "four.json")) as f:
        four = json.load(f)
    return dict(ref=ref, flat=flat, port=port, two=two, four=four)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_reference_and_flat_f64(runs, case):
    """Final pos, vel and spin within 1e-9 of the reference's sharded run
    and of the port's flat Engine, across >= 1 rebuild with migrations."""
    port, ref = runs["port"][case], runs["ref"]
    (_, flat_state, flat_rebuilds) = runs["flat"][case]
    assert int(port["rebuilds"]) >= 1 and int(port["migrated"]) > 0, port
    assert int(port["rebuilds"]) == int(ref[f"{case}_rebuilds"])
    assert int(port["migrated"]) == int(ref[f"{case}_migrated"])
    assert flat_rebuilds >= 1
    for k in ("pos", "vel", "spin"):
        assert np.abs(port[k] - ref[f"{case}_{k}"]).max() < 1e-9, (case, k)
        assert np.abs(port[k] - getattr(flat_state, k).numpy()).max() < 1e-9


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_forces_match_flat_at_construction(runs, case):
    """The distributed E, F (reaction fold or q_Fp halo) and H_eff equal
    the flat evaluation at step 0."""
    port = runs["port"][case]
    (e0, f0, h0), _, _ = runs["flat"][case]
    assert abs(float(port["e0"]) - e0) < 1e-10
    assert np.abs(port["f0"] - f0.numpy()).max() < 1e-11
    assert np.abs(port["h0"] - h0.numpy()).max() < 1e-11


@pytest.mark.parametrize("case", list(CASES))
def test_one_drift_halo_per_step(runs, case):
    port = runs["port"][case]
    assert int(port["drift"]) == int(port["steps"])
    assert bool(port["allgather"])      # auto: every axis <= 8 wide


@pytest.mark.parametrize("ranks", ["two", "four"])
def test_halo_exchange_and_fold_against_numpy(runs, ranks):
    """exchange_halo / exchange_halo_multi against np.pad(wrap) of the
    global array and fold_halo(_multi) against its scatter-add adjoint, in
    both
    halo modes, on a 1-D and a 2x2 mesh: the exchanges exactly, the folds
    to rounding."""
    errs = runs[ranks]["halo"]
    assert len(errs) == 10
    for name, err in errs.items():
        # exchanges copy; a fold adds up to 8 contributions in its own order
        assert err < (1e-13 if name.startswith("fold") else 1e-300), \
            (ranks, name, err)


def test_md_step_ppermute_engine_matches_flat(tmp_path, monkeypatch):
    """``launch/md_step.py --nproc 2 --backend gloo --halo-mode ppermute
    --check-flat``: the Engine's Sharded plan with its exchanges and
    adjoint folds as ``batch_isend_irecv`` pairs, f64 NVE from the
    launcher's state, within 1e-9 of the flat Engine over a rebuild with
    migrations, one drift-pos exchange a step.  Rank 0's result comes
    through ``--out``, not the standard output the ranks share."""
    from repro_torch.launch import md_step
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the spawned ranks
    out = tmp_path / "res.json"
    assert md_step.main(["--nproc", "2", "--backend", "gloo", "--device",
                         "cpu", "--check-flat", "--halo-mode", "ppermute",
                         "--steps", "20", "--chunk", "10",
                         "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["ranks"] == 2 and res["allgather"] is False
    assert res["vs_flat"] < 1e-9
    assert res["rebuilds"] >= 1 and res["migrated"] > 0
    assert res["halo_counts"]["drift-pos"] == 30      # warm 10 + 20 steps


def test_sharded_resume_is_bitwise(runs):
    """Each rank saves its shard and generator, rank 0 the manifest; a
    fresh Engine restored at chunk 1 runs chunk 2 bitwise as the
    uninterrupted run, thermostat noise included."""
    res = runs["two"]["resume"]
    assert res["bitwise"] == 1.0 and res["rebuilds_equal"] == 1.0, res


def test_k2_reads_abar_rows_past_the_atoms(runs):
    """K2's plain version with ``abar`` of n_src > n rows (own rows first)
    against the reference's K2 on the gathered (abar_i, abar_j) form."""
    ref = runs["ref"]
    spec = NEPSpinSpec(**SPEC)
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=F64)
    t = {k: torch.from_numpy(ref[f"k2_{k}"]) for k in
         ("dr", "mask", "idx", "ti", "tj", "si", "sj", "abar")}
    f, h2 = force_pass_plain(spec, params, t["dr"], t["mask"], t["idx"],
                             t["ti"], t["tj"], t["si"], t["sj"], t["abar"])
    assert t["abar"].shape[0] > t["dr"].shape[0]
    for got, want in ((f, ref["k2_f"]), (h2, ref["k2_h2"])):
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(got.numpy() - want).max() / scale < 1e-12


def test_one_rank_plan_matches_flat():
    """Without a process group the plan is one rank that issues no
    collectives (a size-1 sharded axis is the periodic self-wrap); it
    tracks the flat Engine through rebuilds and migrations."""
    lat = simple_cubic()
    from repro_torch.md.state import init_state
    st = init_state(lat, (6, 6, 6), temperature=400.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(2), dtype=F64,
                    device="cpu")
    kw = dict(masses=torch.tensor(lat.masses, dtype=F64),
              magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
              capacity=32, skin=0.2, device="cpu")
    pot, cfg = HeisenbergDMIModel(d0=0.01), IntegratorConfig(dt=2e-3)
    flat = Engine(pot, cfg, st, **kw)
    sh = Engine(pot, cfg, st, plan="sharded", **kw)
    assert sh._rplan.world == 1 and sh._rplan.mesh is None
    flat.run(20, chunk=CHUNK)
    sh.run(20, chunk=CHUNK)
    assert sh.n_rebuilds >= 1 and sh.n_migrated > 0
    assert np.isfinite(sh.trace.values["energy"]).all()
    for k in ("pos", "vel", "spin"):
        diff = (getattr(sh.state, k) - getattr(flat.state, k)).abs().max()
        assert float(diff) < 1e-9, k
    assert sh.trace.health["cell_occ"].max() <= 1.0
    # rebind re-resolves the cells from the synced state: the trajectory
    # state and the counts carry over
    before, rebuilds = sh.state, sh.n_rebuilds
    sh.rebind(skin=0.3)
    assert sh.skin == 0.3 and sh.state.step == 20
    assert sh.n_rebuilds == rebuilds
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(sh.state, k), getattr(before, k))


def test_migration_overflow_counted_not_silent():
    """4 atoms into a 3-slot cell (1 overflow) and a 2-cell jump (1 lost):
    2 dropped, 3 survivors, as the reference counts them."""
    from repro_torch.parallel.domain import (DomainSpec, migrate_cells,
                                             pack_domain)
    from repro_torch.parallel.halo import halo_axes
    dspec = DomainSpec(cells=(3, 3, 3), capacity=3, cutoff=5.0,
                       box=(18.0, 18.0, 18.0), axis_map=(None, None, None),
                       skin=0.2)
    pos = np.asarray([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0], [3.0, 3.0, 3.0],
                      [7.0, 1.0, 1.0], [13.0, 1.0, 1.0]])
    zeros = np.zeros_like(pos)
    dst, extras = pack_domain(dspec, pos, zeros, zeros,
                              np.zeros(5, np.int32),
                              extras={"aid": np.arange(5, dtype=np.int32)})
    aid = extras["aid"].reshape(-1)
    posf = dst.pos.reshape(-1, 3).clone()
    posf[int(torch.nonzero(aid == 3)[0])] = torch.tensor([4.0, 4.0, 4.0])
    posf[int(torch.nonzero(aid == 4)[0])] = torch.tensor([1.5, 1.5, 1.5])
    out = migrate_cells(dspec, halo_axes(None, dspec.axis_map), (3, 3, 3),
                        (0, 0, 0), posf.reshape(dst.pos.shape), dst.vel,
                        dst.spin, dst.types, extras["aid"])
    types, new_aid, moved, dropped = out[3], out[4], out[5], out[6]
    assert int(dropped) == 2 and int(moved) == 2
    assert int((types >= 0).sum()) == 3 and int((new_aid >= 0).sum()) == 3


def test_pack_unpack_and_unbin_round_trip():
    """Binning into the cell grid and back: ``unpack_domain`` gives the
    atoms in cell order, ``unbin_cells`` in their original order; a cell
    past its capacity raises."""
    from repro_torch.parallel.domain import (DomainSpec, pack_domain,
                                             unbin_cells, unpack_domain)
    rng = np.random.default_rng(5)
    pos = rng.random((40, 3)) * 18.0
    vel, spin = rng.normal(size=(40, 3)), rng.normal(size=(40, 3))
    types = rng.integers(0, 2, 40).astype(np.int32)
    kw = dict(cells=(3, 3, 3), cutoff=5.0, box=(18.0, 18.0, 18.0))
    dst, extras = pack_domain(DomainSpec(capacity=12, **kw), pos, vel, spin,
                              types,
                              extras={"aid": np.arange(40, dtype=np.int32)})
    assert int(dst.mask.sum()) == 40 and dst.pos.shape == (3, 3, 3, 12, 3)
    back = unbin_cells(extras["aid"], dst.pos, dst.vel, dst.spin, dst.types)
    for got, want in zip(back, (pos, vel, spin, types)):
        assert np.array_equal(got, want)
    flat = np.c_[unpack_domain(dst)]
    assert sorted(map(tuple, flat)) == sorted(
        map(tuple, np.c_[pos, vel, spin, types]))
    with pytest.raises(ValueError, match="overflow"):
        pack_domain(DomainSpec(capacity=1, **kw), pos, vel, spin, types)


def test_check_dropped_raises_overflow():
    lat = simple_cubic()
    from repro_torch.md.state import init_state
    st = init_state(lat, (6, 6, 6), temperature=300.0, dtype=F64,
                    device="cpu")
    eng = Engine(HeisenbergDMIModel(d0=0.01), IntegratorConfig(), st,
                 masses=torch.tensor(lat.masses, dtype=F64),
                 magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                 capacity=32, skin=0.2, plan=Sharded(), device="cpu")
    eng._carry = eng._carry._replace(n_dropped=np.asarray([3]))
    with pytest.raises(HealthError, match="overflow") as err:
        eng._check_dropped(chunk_index=4)
    assert err.value.kind == "overflow" and err.value.chunk_index == 4
    assert err.value.signals["dropped"] == 3


def test_plan_errors_and_facade():
    """Replicas on the spatial mesh resolve on one rank (every replica
    local); a device subset of more than one rank needs a process group,
    ``devices=(0,)`` is the one-rank plan; SimulationSharded runs the
    plan."""
    assert as_plan("sharded") == Sharded()
    assert as_plan("sharded", replicas=2) == Sharded(replicas=2)
    with pytest.raises(ValueError, match="replicas >= 0"):
        Sharded(replicas=-1)
    with pytest.raises(ValueError, match="names no rank"):
        Sharded(devices=())
    box = torch.full((3,), 18.0, dtype=F64)
    pos = torch.rand((64, 3), generator=torch.Generator().manual_seed(1),
                     dtype=F64) * 18.0
    rp = Sharded(replicas=2).resolve(box, pos, 5.0, 0.2, False)
    assert (rp.replicas, rp.local_replicas(), rp.replica_offset(),
            rp.rep_in_mesh(), rp.spatial_axes) == (2, 2, 0, False, ("sx",))
    assert rp.describe()["devices"] == 1 and rp.rank == 0
    with pytest.raises(ValueError, match="process group"):
        Sharded(devices=(0, 1)).resolve(box, pos, 5.0, 0.2, False)
    one = Sharded(devices=(0,)).resolve(box, pos, 5.0, 0.2, False)
    assert one.world == 1 and one.mesh is None
    from repro_torch.md.simulate import SimulationSharded
    from repro_torch.md.state import init_state
    lat = simple_cubic()
    st = init_state(lat, (6, 6, 6), temperature=300.0, dtype=F64,
                    device="cpu")
    sim = SimulationSharded(HeisenbergDMIModel(d0=0.01),
                            IntegratorConfig(dt=2e-3), st,
                            torch.tensor(lat.masses, dtype=F64),
                            torch.tensor(lat.moments) > 0, 5.0, skin=0.2,
                            device="cpu")
    sim.run(4, chunk=2)
    assert sim.trace.energy.shape == (2,) and sim.state.step == 4
    assert sim.halo_ledger.counts["drift-pos"] == 4
