"""The port's legacy per-evaluation domain paths against the JAX package's,
on gloo ranks.

One f64 JAX subprocess with 8 forced host devices runs the MD part of
``tests/test_domain.py``'s script: simple cubic 5^3 at 300 K with random
spins, ``NEPSpinSpec(n_types=1, l_max=2, n_ang=2, n_rad=4, n_spin=2,
basis_size=6)``, the dense evaluation, then on a 2x2x2 ("pod", "data",
"model") mesh over a 4^3 cell grid of capacity 8 the 27-stencil path
(``distributed_energy_fn``), the pruned path (capacity 32) and the kernel
path (K1 -> q_Fp halo -> K2).  It saves the state, the weights and every
E/F/H_eff, the dense ones re-binned into the cell grid.

The port spawns 8 gloo ranks (``parallel/ranks.py:spawn``) on the same mesh
as a ``DeviceMesh``; each rank bins the reference's state with the port's
``pack_domain``, takes its slab and runs ``distributed_energy_fn``,
``distributed_energy_fn_pruned`` and ``distributed_kernel_force_fn`` (K1/K2's
plain versions on the CPU) from the reference's weights.  The bars are the
reference's own (``tests/test_domain.py``): the stencil path's E within
1e-10 and F/H_eff within 1e-12 of the dense evaluation; the pruned and
kernel paths' E within 1e-8 and F (and H_eff) within 1e-10 of the stencil
path, the port's and the reference's alike.  The halo ledger records each
path's exchanges, folds and energy reductions with bytes > 0 (the
reference's collective-bytes case), and a ``DomainState`` round-trips the
port's checkpoint bitwise.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
SPEC = dict(n_types=1, l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
DOMAIN = dict(cells=(4, 4, 4), capacity=8, cutoff=5.0)
AXES = ("pod", "data", "model")
PATHS = ("stencil", "pruned", "kernel")

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from repro.md.lattice import simple_cubic
from repro.md.state import init_state
from repro.md.neighbor import dense_neighbor_table
from repro.core.descriptor import NEPSpinSpec
from repro.core.potential import init_params, energy_forces_field
from repro.parallel.domain import (DomainSpec, pack_domain,
                                   distributed_energy_fn,
                                   distributed_energy_fn_pruned,
                                   distributed_kernel_force_fn)

spec_kw, dom = eval(sys.argv[2])
lat = simple_cubic()
st = init_state(lat, (5, 5, 5), temperature=300.0, spin_init="random",
                key=jax.random.PRNGKey(7))
spec = NEPSpinSpec(**spec_kw)
params = init_params(spec, jax.random.PRNGKey(0))
tab = dense_neighbor_table(st.pos, st.box, 5.0, 40)
e_ref, f_ref, h_ref = energy_forces_field(spec, params, st.pos, st.spin,
                                          st.types, tab, st.box)
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
dspec = DomainSpec(box=tuple(np.asarray(st.box)),
                   axis_map=("pod", "data", "model"), **dom)
dspec.check()
dst = pack_domain(dspec, st.pos, st.vel, st.spin, st.types)
dense = pack_domain(dspec, st.pos, f_ref, h_ref, st.types)
out = {k: np.asarray(getattr(st, k))
       for k in ("pos", "vel", "spin", "types", "box")}
out.update({f"param_{i}": np.asarray(x) for i, x in enumerate(params)})
out.update(cell_pos=np.asarray(dst.pos), dense_e=np.asarray(e_ref),
           dense_f=np.asarray(dense.vel), dense_h=np.asarray(dense.spin))
_, effn = distributed_energy_fn(spec, dspec, mesh)
build, effn_p = distributed_energy_fn_pruned(spec, dspec, mesh, capacity=32)
buildk, effn_k = distributed_kernel_force_fn(spec, dspec, mesh, capacity=32)
# jitted: op-by-op dispatch over 8 devices takes minutes
effn, build, effn_p, buildk, effn_k = map(jax.jit, (effn, build, effn_p,
                                                    buildk, effn_k))
with jax.set_mesh(mesh):
    res = {"stencil": effn(params, dst)}
    idx, nmask = build(dst.pos, dst.types, dst.mask)
    res["pruned"] = effn_p(params, dst.pos, dst.spin, dst.types, dst.mask,
                           idx, nmask)
    idx, nmask = buildk(dst.pos, dst.types, dst.mask)
    res["kernel"] = effn_k(params, dst.pos, dst.spin, dst.types, dst.mask,
                           idx, nmask)
for name, (e, f, h) in res.items():
    out.update({f"{name}_e": np.asarray(e), f"{name}_f": np.asarray(f),
                f"{name}_h": np.asarray(h)})
np.savez(sys.argv[1], **out)
"""


def _setup(d):
    """The reference's state, binned by the port, its weights and the
    domain spec."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.potential import params_from_jax
    from repro_torch.parallel.domain import DomainSpec, pack_domain
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    spec = NEPSpinSpec(**SPEC)
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=F64)
    dspec = DomainSpec(box=tuple(float(b) for b in ref["box"]),
                       axis_map=AXES, **DOMAIN)
    t = lambda k, dt=F64: torch.as_tensor(ref[k], dtype=dt)
    dst = pack_domain(dspec, t("pos"), t("vel"), t("spin"),
                      t("types", torch.int32))
    return ref, spec, params, dspec, dst


def _domain_rank(rank, d):
    """Every path on this rank's slab; rank 0 writes the max errors over
    the ranks and the ledgers."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.parallel.domain import (DomainState,
                                             distributed_energy_fn,
                                             distributed_energy_fn_pruned,
                                             distributed_kernel_force_fn)
    from repro_torch.parallel.halo import HaloTrace, halo_axes
    torch.set_num_threads(1)
    ref, spec, params, dspec, dst = _setup(d)
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=AXES)
    axes = halo_axes(mesh, AXES)
    local = dspec.local_shape({a: 2 for a in AXES})
    cut = tuple(slice(ax.index * c, (ax.index + 1) * c)
                for ax, c in zip(axes, local))
    mine = DomainState(*(x[cut].contiguous() for x in dst))
    got, ledgers = {}, {}
    efn, effn = distributed_energy_fn(spec, dspec, mesh)
    with HaloTrace() as ledgers["stencil"]:
        got["stencil"] = effn(params, mine)
    e_only = efn(params, mine)
    for name, make in (("pruned", distributed_energy_fn_pruned),
                       ("kernel", distributed_kernel_force_fn)):
        with HaloTrace() as ledgers[name]:
            build, fn = make(spec, dspec, mesh, capacity=32)
            idx, nmask = build(mine.pos, mine.types, mine.mask)
            got[name] = fn(params, mine.pos, mine.spin, mine.types,
                           mine.mask, idx, nmask)
    r = lambda k: torch.from_numpy(ref[k][cut])
    errs = {"pack_pos": float((mine.pos - r("cell_pos")).abs().max()),
            "energy_only": abs(float(e_only - got["stencil"][0]))}
    for name, (e, f, h) in got.items():
        errs[f"{name}_vs_ref_e"] = abs(float(e) - float(ref[f"{name}_e"]))
        errs[f"{name}_vs_ref_f"] = float((f - r(f"{name}_f")).abs().max())
        errs[f"{name}_vs_ref_h"] = float((h - r(f"{name}_h")).abs().max())
        es, fs, hs = got["stencil"]
        errs[f"{name}_vs_stencil_e"] = abs(float(e - es))
        errs[f"{name}_vs_stencil_f"] = float((f - fs).abs().max())
        errs[f"{name}_vs_stencil_h"] = float((h - hs).abs().max())
    errs["dense_e"] = abs(float(got["stencil"][0]) - float(ref["dense_e"]))
    errs["dense_f"] = float((got["stencil"][1] - r("dense_f")).abs().max())
    errs["dense_h"] = float((got["stencil"][2] - r("dense_h")).abs().max())
    ck = os.path.join(d, f"ck{rank}")
    save_checkpoint(ck, 3, mine).join()
    loaded, step = load_checkpoint(ck, mine)
    errs["ckpt_bad"] = float(step != 3 or not all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(mine, loaded)))
    keys = sorted(errs)
    vec = torch.tensor([errs[k] for k in keys], dtype=F64)
    dist.all_reduce(vec, op=dist.ReduceOp.MAX)
    if rank == 0:
        with open(os.path.join(d, "port.json"), "w") as f:
            json.dump({"errs": dict(zip(keys, vec.tolist())),
                       "ledgers": {k: v.snapshot()
                                   for k, v in ledgers.items()}}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.parallel.ranks import spawn
    d = str(tmp_path_factory.mktemp("domain"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, os.path.join(d, "ref.npz"),
         repr((SPEC, DOMAIN))],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    spawn(_domain_rank, 8, d, workdir=d)
    with open(os.path.join(d, "port.json")) as f:
        return json.load(f)


def test_port_bins_the_reference_state_identically(runs):
    assert runs["errs"]["pack_pos"] == 0.0


def test_stencil_energy_matches_dense_reference(runs):
    errs = runs["errs"]
    assert errs["dense_e"] < 1e-10
    assert errs["energy_only"] < 1e-10


def test_stencil_forces_and_fields_match_dense_reference(runs):
    assert runs["errs"]["dense_f"] < 1e-12
    assert runs["errs"]["dense_h"] < 1e-12


@pytest.mark.parametrize("path", ["pruned", "kernel"])
def test_path_matches_stencil(runs, path):
    """The pre-staged table and the kernels over it (K1/K2's plain
    versions, the q_Fp halo) are exact against the 27-stencil path."""
    errs = runs["errs"]
    assert errs[f"{path}_vs_stencil_e"] < 1e-8
    assert errs[f"{path}_vs_stencil_f"] < 1e-10
    assert errs[f"{path}_vs_stencil_h"] < 1e-10


@pytest.mark.parametrize("path", PATHS)
def test_path_matches_the_references_same_path(runs, path):
    errs = runs["errs"]
    assert errs[f"{path}_vs_ref_e"] < 1e-8
    assert errs[f"{path}_vs_ref_f"] < 1e-10
    assert errs[f"{path}_vs_ref_h"] < 1e-10


@pytest.mark.parametrize("path", PATHS)
def test_halo_ledger_records_the_collectives(runs, path):
    """Every exchange, fold and energy reduction is in the ledger with its
    bytes (the reference reads them from the compiled HLO): the autograd
    paths fold the pos and spin gradients back, the kernel path sends its
    adjoints in one q_Fp round."""
    from repro_torch.utils.collectives import (collective_bytes,
                                               parse_collectives)
    ledger = runs["ledgers"][path]
    kinds = parse_collectives(ledger)
    assert collective_bytes(ledger) > 0
    assert kinds["energy"]["count"] == 3          # one per sharded axis
    want = {"stencil": ("legacy-pos", "legacy-spin", "legacy-types",
                        "legacy-ids", "legacy-adjoint"),
            "pruned": ("rebuild", "legacy-pos", "legacy-spin",
                       "legacy-types", "legacy-adjoint"),
            "kernel": ("rebuild", "legacy-pos", "legacy-types", "qfp")}[path]
    for tag in want:
        assert kinds[tag]["bytes"] > 0, (path, tag, kinds)
    if path != "kernel":
        assert kinds["legacy-adjoint"]["count"] == 2     # pos and spin


def test_domain_state_checkpoint_roundtrip(runs):
    assert runs["errs"]["ckpt_bad"] == 0.0
