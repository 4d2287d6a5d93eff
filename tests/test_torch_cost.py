"""The port's cost tools, Hopper roofline and MD dry run against the JAX
package's.

In-process at f32: ``utils/tree.py`` on the reference's ``NEPSpinParams``
carried over; ``utils/cost.py``'s FLOPs equal to ``lowered_cost``'s on plain
products and einsums, its anchor bytes equal on a row gather, and the NEP
MLP energy's FLOPs within 0.1 % (the per-type bias add and select count
one output element each on both sides, but JAX broadcasts the bias and
selects through a nested jaxpr: 161,350 against 161,400 here); the
analytic NEP model (``nep_abar_row``, ``nep_pair_flops``, ``nep_analytic``'s
FLOPs and bytes) equal to the reference's at the production and smoke
specs; ``terms`` under the H100's constants; ``roofline_table`` and
``summary`` line for line as the reference's.

Across processes, at the same time: a child process counts the MD dry run
on a fake world of 8 ranks (a 2x2x2 mesh) at a per-rank grid of 3^3 cells,
both step implementations, and builds the production meshes on a fake
world of 512; one JAX subprocess with 8 forced host devices lowers the
reference's ``build_md_dryrun`` for the same cell.  The grid is registered
in both packages' ``MD_SHAPES`` inside those processes only.  The port's
FLOPs per rank lie within 0.5-2x of the reference's ``jaxpr_cost / n_dev``
(0.69 for the stencil step and 0.65 for the pruned one when this was
written).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.utils.cost import CostCounter, lowered_cost
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID = (3, 3, 3)
IMPLS = ("stencil", "pruned")

_PORT_SCRIPT = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun, md_step
from repro_torch.launch.mesh import (dp_axes, dp_size, make_production_mesh,
                                     make_test_mesh, tp_size)
md_step.MD_SHAPES["md_test"] = tuple(json.loads(sys.argv[1]))
out = {}
with dryrun.fake_world(512):
    for pods in (False, True):
        m = make_production_mesh(multi_pod=pods)
        out[f"mesh_{int(m.mesh.numel())}"] = [list(dp_axes(m)), dp_size(m),
                                              tp_size(m),
                                              list(m.mesh_dim_names)]
with dryrun.fake_world(8):
    mesh = make_test_mesh()
    for impl in ("stencil", "pruned"):
        meta = md_step.build_md_dryrun("md_test", mesh, impl=impl)
        out[impl] = dryrun.analyze(meta, "fege-spinlattice", "md_test", mesh)
print("RESULT " + json.dumps(out, default=str))
"""

_JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
from repro.launch import md_step
md_step.MD_SHAPES["md_test"] = tuple(json.loads(sys.argv[1]))
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {}
for impl in ("stencil", "pruned"):
    _, _, meta = md_step.build_md_dryrun("md_test", mesh, impl=impl)
    out[impl] = {"flops_per_dev": meta["jaxpr_cost"]["flops"] / mesh.size,
                 "atoms": meta["atoms"],
                 "atoms_per_device": meta["atoms_per_device"],
                 "cells": list(meta["cells"]), "capacity": meta["capacity"]}
print("RESULT " + json.dumps(out))
"""


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def dry():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD, OMP_NUM_THREADS="1")
    grid = json.dumps(GRID)
    kw = dict(env=env, cwd=ROOT, stdout=subprocess.PIPE,
              stderr=subprocess.PIPE, text=True)
    port = subprocess.Popen([sys.executable, "-c", _PORT_SCRIPT, grid], **kw)
    ref = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, grid], **kw)
    return {"port": _result(port), "ref": _result(ref)}


# ---------------------------------------------------------------------------
# utils/tree.py
# ---------------------------------------------------------------------------

def _params():
    from repro.core.descriptor import NEPSpinSpec
    from repro.core.potential import init_params
    from repro_torch.core.potential import params_from_jax
    spec = NEPSpinSpec(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
    jp = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_jax([np.asarray(x) for x in jp], device="cpu")


def test_tree_utils_match_reference():
    from repro.utils import tree as jtree
    from repro_torch.utils import tree
    jp, tp = _params()
    assert tree.tree_count(tp) == jtree.tree_count(jp)
    assert tree.tree_bytes(tp) == jtree.tree_bytes(jp)
    assert tree.tree_bytes({"a": tp, "b": [tp.w1]}) == \
        jtree.tree_bytes({"a": jp, "b": [jp.w1]})
    cast = tree.tree_cast(tp, torch.float64)
    assert type(cast) is type(tp)
    assert all(x.dtype == torch.float64 for x in cast)
    assert tree.tree_bytes(cast) == jtree.tree_bytes(
        jtree.tree_cast(jp, jnp.float64)) * (
        1 if jax.config.jax_enable_x64 else 2)
    zeros = tree.tree_zeros_like(tp)
    assert all(not z.any() and z.shape == x.shape for z, x in zip(zeros, tp))
    got, want = float(tree.global_norm(tp)), float(jtree.global_norm(jp))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# utils/cost.py against jaxpr_cost
# ---------------------------------------------------------------------------

def _jax_cost(fn, *args):
    from repro.utils.jaxpr_cost import lowered_cost as jlc
    return jlc(jax.make_jaxpr(fn)(*args))


_RNG = np.random.default_rng(0)
_F = lambda *s: _RNG.normal(size=s).astype(np.float32)
PRODUCTS = {
    "matmul": (lambda x, y: x @ y, (_F(5, 7, 3), _F(5, 3, 4))),
    "mm": (lambda x, y: x @ y, (_F(9, 6), _F(6, 4))),
    "einsum_bij": ("bij,bjk->bik", (_F(5, 7, 3), _F(5, 3, 4))),
    "einsum_radial": ("...mk,...mnk->...mn", (_F(4, 6, 8), _F(4, 6, 3, 8))),
    "einsum_spin": ("...mj,...m->...j", (_F(4, 6, 8), _F(4, 6))),
    "einsum_vec": ("...mj,...md->...jd", (_F(4, 6, 8), _F(4, 6, 3))),
}


@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_product_flops_equal_reference(case):
    fn, args = PRODUCTS[case]
    if isinstance(fn, str):
        eq = fn
        tfn = lambda *a: torch.einsum(eq, *a)
        jfn = lambda *a: jnp.einsum(eq, *a)
    else:
        tfn = jfn = fn
    got = lowered_cost(tfn, *(torch.from_numpy(a) for a in args))
    want = _jax_cost(jfn, *args)
    assert got["flops"] == want["flops"] > 0
    assert got["bytes_anchor"] == want["bytes_anchor"]


def test_row_gather_anchor_bytes_equal_reference():
    x = _F(5, 7, 3)
    idx = _RNG.integers(0, 35, (6, 4)).astype(np.int32)
    got = lowered_cost(lambda a, i: a.reshape(-1, 3)[i], torch.from_numpy(x),
                       torch.from_numpy(idx))
    want = _jax_cost(lambda a, i: a.reshape(-1, 3)[i], x, idx)
    assert got["bytes_anchor"] == want["bytes_anchor"] > 0
    assert got["flops"] == 0


def test_mlp_energy_flops_match_reference():
    """Within 0.1 %: both count the products exactly; the per-type bias
    adds and selects differ by one output row (module docstring)."""
    from repro.core.potential import mlp_energy as jmlp
    from repro_torch.core.potential import mlp_energy
    from repro_torch.utils.collectives import count_op
    jp, tp = _params()
    q = _F(50, tp.w1.shape[1])
    ti = _RNG.integers(0, 2, 50).astype(np.int32)
    want = _jax_cost(lambda a, t: jmlp(jp, a, t), q, ti)
    with CostCounter() as counter:
        mlp_energy(tp, torch.from_numpy(q), torch.from_numpy(ti))
    got = counter.cost()
    assert abs(got["flops"] / want["flops"] - 1) < 1e-3, (got, want)
    assert got["bytes_anchor"] == want["bytes_anchor"]
    assert count_op(counter, "mm") == 2 and count_op(counter, "mv") == 2
    assert count_op(counter.record(), "tanh") == 2


def test_peak_bytes_track_live_outputs():
    with CostCounter() as counter:
        a = torch.ones(1000)              # 4,000 bytes
        b = a * 2                         # 4,000
        del b
        c = (a + 1).reshape(10, 100)      # 4,000 (the view adds none)
    assert counter.peak_bytes == 8000 and c.shape == (10, 100)


# ---------------------------------------------------------------------------
# launch/roofline.py
# ---------------------------------------------------------------------------

def _specs():
    from repro.configs.fege_spinlattice import config as jconf
    from repro.configs.fege_spinlattice import smoke_config as jsmoke
    from repro_torch.configs.fege_spinlattice import config, smoke_config
    return {"production": (config().spec, jconf().spec),
            "smoke": (smoke_config().spec, jsmoke().spec)}


@pytest.mark.parametrize("which", ["production", "smoke"])
def test_nep_analytic_equals_reference(which):
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline
    spec, jspec = _specs()[which]
    assert roofline.nep_abar_row(spec) == jroof.nep_abar_row(jspec)
    assert roofline.nep_pair_flops(spec) == jroof.nep_pair_flops(jspec)
    for n, m in ((262144, 64), (4096, 40)):
        got = roofline.nep_analytic(spec, n, m)
        want = jroof.nep_analytic(jspec, n, m)
        for k in ("flops", "k1_flops", "k2_flops", "gather_bytes_abar_j",
                  "hbm_bytes", "abar_row", "arithmetic_intensity"):
            assert got[k] == want[k], (which, k)
        assert got["compute_s"] == got["flops"] / 67e12
        assert got["memory_s"] == got["hbm_bytes"] / 3.35e12


def _record(devices, **kw):
    rec = {"arch": "fege-spinlattice", "shape": "md_small", "devices":
           devices, "meta": {"kind": "md", "tokens": 1000,
                             "dtype": "float32"},
           "flops_total": 1e12, "bytes_total": 1e10,
           "collectives": {"legacy-pos": {"count": 1, "bytes": 6e7},
                           "energy": {"count": 2, "bytes": 4e7}}}
    rec.update(kw)
    return rec


def test_terms_use_the_hopper_constants():
    """The same per-rank record is compute-bound on the H100 (f32 off the
    tensor cores) where the reference's TPU constants make it
    memory-bound; the collective term reads NVLink within one host and the
    inter-host port beyond."""
    from repro.launch import roofline as jroof
    from repro_torch.launch import roofline
    big = roofline.terms(_record(256))
    assert big["bottleneck"] == "compute"
    assert jroof.terms(_record(256))["bottleneck"] == "memory"
    assert big["compute_s"] == 1e12 / 67e12
    assert big["memory_s"] == 1e10 / 3.35e12
    assert big["collective_s"] == 1e8 / (400e9 / 8)     # 400 Gb/s NDR
    assert big["collective_link"] == "infiniband-ndr"
    small = roofline.terms(_record(8, collectives={"qfp": {
        "count": 1, "bytes": 9e11}}))
    assert small["collective_link"] == "nvlink"
    assert small["collective_s"] == 9e11 / 450e9
    assert small["bottleneck"] == "collective"
    bf16 = roofline.terms(_record(8, meta={"kind": "md", "tokens": 0,
                                           "dtype": "bfloat16"}))
    assert bf16["compute_s"] == 1e12 / 989e12
    assert bf16["bottleneck"] == "memory"


def test_model_flops_match_reference_and_name_missing_archs():
    from repro.launch import roofline as jroof
    from repro_torch import configs
    from repro_torch.launch import roofline
    assert roofline.model_flops("fege-spinlattice", "md", 10) == 0.0
    for arch in configs.ARCHS:
        for kind in ("prefill", "train"):
            assert roofline.model_flops(arch, kind, 64) == \
                jroof.model_flops(arch, kind, 64)
    with pytest.raises(KeyError, match="unknown"):
        roofline.model_flops("no-such-arch", "train", 64)


def test_nep_measured_refuses_host_tensors():
    from repro_torch.launch import roofline
    spin = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="card"):
        roofline.nep_measured(None, None, None, spin, None)


def test_kernel_bound_is_the_larger_of_bytes_and_operations():
    from repro_torch.launch import roofline
    b = roofline.bound(685.8e6, 1e9, torch.float32)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == 1e3 * 685.8e6 / 3.35e12
    b = roofline.bound(1e6, 33.51e9, "float32")
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == 1e3 * 33.51e9 / 67e12


# ---------------------------------------------------------------------------
# launch/report.py's dry-run tables
# ---------------------------------------------------------------------------

def _records():
    ok = _record(256, mesh={"data": 16, "model": 16},
                 memory={"argument_bytes": 3.2e9})
    from repro_torch.launch import roofline
    ok["roofline"] = roofline.terms(ok)
    ok2 = dict(ok, shape="md_large", mesh={"pod": 2, "data": 16,
                                           "model": 16})
    ok2["roofline"] = dict(ok["roofline"], collective_s=2.5e-3,
                           useful_flops_ratio=0.5)
    train = dict(ok, arch="zamba2-2.7b", shape="train_4k",
                 meta={"kind": "train"})
    return [ok, ok2, train,
            {"arch": "qwen2-7b", "shape": "long_500k", "mesh": {
                "data": 16, "model": 16}, "skipped": "no long context"},
            {"arch": "qwen2-7b", "shape": "train_4k", "mesh": {
                "pod": 2, "data": 16, "model": 16}, "error": "boom"}]


def test_report_tables_render_as_the_reference():
    from repro.launch import report as jreport
    from repro_torch.launch import report
    recs = _records()
    assert report.summary(recs).splitlines() == \
        jreport.summary(recs).splitlines()
    for pod in ("pod1", "pod2"):
        assert report.roofline_table(recs, pod).splitlines() == \
            jreport.roofline_table(recs, pod).splitlines()
    assert report.fmt_e(None) == jreport.fmt_e(None) == "-"
    assert report.fmt_e(1234.5) == jreport.fmt_e(1234.5)


def test_report_loads_records(tmp_path):
    from repro_torch.launch import report
    for i, r in enumerate(_records()):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert report.load_all(str(tmp_path)) == _records()


# ---------------------------------------------------------------------------
# the MD dry run on a fake world
# ---------------------------------------------------------------------------

def test_production_meshes_on_a_fake_world(dry):
    port = dry["port"]
    assert port["mesh_512"] == [["pod", "data"], 32, 16,
                                ["pod", "data", "model"]]
    assert port["mesh_256"] == [["data"], 16, 16, ["data", "model"]]


@pytest.mark.parametrize("impl", IMPLS)
def test_dryrun_record_fields(dry, impl):
    rec, ref = dry["port"][impl], dry["ref"][impl]
    assert rec["devices"] == 8 and rec["mesh"] == {"pod": 2, "data": 2,
                                                   "model": 2}
    meta = rec["meta"]
    for k in ("atoms", "atoms_per_device", "capacity"):
        assert meta[k] == ref[k], k
    assert list(meta["cells"]) == ref["cells"]
    assert meta["atoms_per_device"] == meta["atoms"] // 8
    assert list(meta["local_cells"]) == list(GRID)
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] > mem["output_bytes"]
    assert rec["card"]["fits"] is True
    coll = rec["collectives"]
    assert sum(v["bytes"] for v in coll.values()) > 0
    assert coll["energy"]["count"] == 3            # one per mesh dimension
    assert coll["legacy-adjoint"]["count"] == 2    # pos and spin folds
    rf = rec["roofline"]
    assert rf["collective_link"] == "nvlink"
    assert rf["bottleneck"] in ("compute", "memory", "collective")
    assert rec["flops_total"] > 0 and rec["bytes_naive"] >= rec[
        "bytes_total"] > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_dryrun_flops_per_rank_near_reference(dry, impl):
    """The op-counted FLOPs of one rank's step within 0.5-2x of the
    reference's jaxpr count over the devices (the two programs differ in
    how their autodiff and rematerialisation lower)."""
    ratio = dry["port"][impl]["flops_total"] / dry["ref"][impl][
        "flops_per_dev"]
    assert 0.5 < ratio < 2.0, ratio
