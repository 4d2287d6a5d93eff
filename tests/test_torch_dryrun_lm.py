"""The dry run's LM cells against the JAX package's lowering.

One module fixture starts two processes at the same time: the port counts
the smoke configs of qwen2-7b (dense), mamba2-2.7b (ssm) and
moonshot-v1-16b-a3b (MoE, expert-parallel under tp) as train (accum 2,
B 8, S 128), prefill and decode cells in a ``fake`` world of 8 ranks on a
2 x 2 x 2 (pod, data, model) mesh (``launch/dryrun.py:lower_lm_cell``);
the reference lowers the same cells on 8 forced host devices
(``make_test_mesh((2, 2, 2))``).  Each process also reports its
``plan_for`` of every ``PLAN_OVERRIDES`` entry (read inside the JAX
process: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``) and its
``long_500k`` record of every full-attention arch.

The reference's ``chunked_attention`` pads the keys up to its
``kv_chunk`` (1024 by default), so at S = 128 it would count every
attention product eight times over; it is given ``kv_chunk`` = 128 here
(the port has no ``kv_chunk``: its flash kernels take any length).  The
port's per-rank FLOPs lie within 0.5-2x of the reference's
``flops_total`` (the bar of the MD cells in ``test_torch_cost.py``;
0.91-1.69 when this was written: the two programs differ in what the
partitioner replicates, e.g. a decode step's tiny activations).  The
argument bytes are the rank's shards of the state, batch and caches,
worked out here from the shapes and the sharding rules.
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-7b", "mamba2-2.7b", "moonshot-v1-16b-a3b")
KINDS = ("train", "prefill", "decode")
ACCUM, BATCH, SEQ = 2, 8, 128
MESH = {"pod": 2, "data": 2, "model": 2}
CELLS = [(a, k) for a in ARCHS for k in KINDS]

_COMMON = r"""
import dataclasses, json, sys, time
ARCHS, KINDS, ACCUM, BATCH, SEQ = json.loads(sys.argv[1])
FULL = [a for a in configs.ARCHS
        if not lm.shape_applicable(configs.get(a), lm.SHAPES["long_500k"])[0]]
configs.get = configs.get_smoke
for k in KINDS:
    lm.SHAPES[k + "_test"] = lm.ShapeSpec(k + "_test", SEQ, BATCH, k)
out = {"plans": {f"{a}|{s}": dataclasses.asdict(D.plan_for(a, s))
                 for a, s in D.PLAN_OVERRIDES},
       "full_attention": FULL, "cells": {}}
"""

_PORT_SCRIPT = r"""
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import lm
""" + _COMMON + r"""
with D.fake_world(8), D.card_dtensor():
    mesh = make_test_mesh((2, 2, 2))
    out["skips"] = {a: D.lower_lm_cell(a, "long_500k", mesh, D.plan_for(
        a, "long_500k")) for a in FULL}
    for a in ARCHS:
        for k in KINDS:
            t0 = time.time()
            plan = D.plan_for(a, k + "_test", {"accum": ACCUM})
            meta = D.lower_lm_cell(a, k + "_test", mesh, plan)
            rec = D.analyze(meta, a, k, mesh)
            rec["plan"] = dataclasses.asdict(plan)
            rec["elapsed_s"] = round(time.time() - t0, 1)
            out["cells"][f"{a}|{k}"] = rec
print("RESULT " + json.dumps(out, default=str))
"""

_JAX_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           + os.environ.get("XLA_FLAGS", ""))
from repro import configs
from repro.launch import dryrun as D
from repro.launch.mesh import make_test_mesh
from repro.models import lm
""" + _COMMON + r"""
mesh = make_test_mesh((2, 2, 2))
out["skips"] = {a: D.lower_lm_cell(a, "long_500k", mesh, D.plan_for(
    a, "long_500k"))[2] for a in FULL}
for a in ARCHS:
    for k in KINDS:
        t0 = time.time()
        plan = D.plan_for(a, k + "_test", {"accum": ACCUM, "kv_chunk": SEQ})
        lowered, compiled, meta = D.lower_lm_cell(a, k + "_test", mesh, plan)
        rec = D.analyze(lowered, compiled, meta, a, k, mesh)
        rec["plan"] = dataclasses.asdict(plan)
        rec["elapsed_s"] = round(time.time() - t0, 1)
        out["cells"][f"{a}|{k}"] = rec
print("RESULT " + json.dumps(out, default=str))
"""


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def dry():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD, OMP_NUM_THREADS="1")
    arg = json.dumps([ARCHS, KINDS, ACCUM, BATCH, SEQ])
    kw = dict(env=env, cwd=ROOT, stdout=subprocess.PIPE,
              stderr=subprocess.PIPE, text=True)
    port = subprocess.Popen([sys.executable, "-c", _PORT_SCRIPT, arg], **kw)
    ref = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, arg], **kw)
    return {"port": _result(port), "ref": _result(ref)}


def _pair(dry, arch, kind):
    key = f"{arch}|{kind}"
    return dry["port"]["cells"][key], dry["ref"]["cells"][key]


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", CELLS)
def test_lm_record_has_the_reference_keys(dry, arch, kind):
    rec, ref = _pair(dry, arch, kind)
    assert "error" not in rec and "skipped" not in rec
    assert set(rec) == set(ref) | {"card"}
    assert set(rec["memory"]) == set(ref["memory"])
    assert rec["mesh"] == ref["mesh"] == MESH and rec["devices"] == 8
    for k in ("kind", "tokens"):
        assert rec["meta"][k] == ref["meta"][k], k
    assert rec["meta"]["dtype"] == "float32"
    assert rec["card"]["fits"] is True
    rf = rec["roofline"]
    assert rf["collective_link"] == "nvlink"
    assert rf["peak_flops"] == 67e12          # the smoke configs are f32
    assert rec["bytes_naive"] >= rec["bytes_total"] > 0
    assert rec["memory"]["temp_bytes"] > 0


@pytest.mark.parametrize("arch,kind", CELLS)
def test_lm_flops_per_rank_near_reference(dry, arch, kind):
    """The port's counted FLOPs of one rank within 0.5-2x of the
    reference's jaxpr count over the devices."""
    rec, ref = _pair(dry, arch, kind)
    ratio = rec["flops_total"] / ref["flops_total"]
    assert 0.5 < ratio < 2.0, ratio


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_tp_train_records_all_reduce(dry, arch):
    coll = _pair(dry, arch, "train")[0]["collectives"]
    assert coll["all-reduce"]["count"] > 0
    assert coll["all-reduce"]["bytes"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_lm_expert_parallel_records_all_to_all(dry, kind):
    """moonshot's MoE layer takes the expert-parallel path under tp: its
    token exchange, two ``all_to_all_single`` a forward of the layer (and
    in a train step as many again for the remat's recompute and for the
    backward, each microbatch), is counted as all-to-all with its
    bytes."""
    from repro_torch import configs
    from repro_torch.models.transformer import layer_groups
    n_moe = sum(g.count for g in layer_groups(
        configs.get_smoke("moonshot-v1-16b-a3b")) if g.kind == "moe")
    rec = _pair(dry, "moonshot-v1-16b-a3b", kind)[0]
    want = 2 * n_moe * (3 * ACCUM if kind == "train" else 1)
    assert rec["meta"]["ops"].get("alltoall_base", 0) == want
    coll = rec["collectives"]["all-to-all"]
    assert coll["count"] >= want and coll["bytes"] > 0


# ---------------------------------------------------------------------------
# argument bytes from the shapes
# ---------------------------------------------------------------------------

def _local_numel(shape, spec) -> int:
    n = 1
    for dim, s in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if s is None else (s if isinstance(s, tuple) else (s,))
        split = 1
        for a in axes:
            split *= MESH[a]
        assert dim % split == 0
        n *= dim // split
    return n


def _tree_bytes(tree, specs) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(tree[k], specs[k]) for k in tree)
    return _local_numel(tree.shape, specs) * tree.element_size()


def _cache_spec(x):
    """The reference's ``_cache_shardings`` rule, from the shape."""
    spec = [None] * x.dim()
    if x.dim() >= 2 and x.shape[1] % 4 == 0:
        spec[1] = ("pod", "data")
    for d in (3, 4):
        if x.dim() > d and x.shape[d] % 2 == 0:
            spec[d] = "model"
            break
    return tuple(spec)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_lm_argument_bytes_are_the_ranks_shards(dry, arch, kind):
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import opt_pspecs, param_pspecs
    mesh = types.SimpleNamespace(shape=MESH, axis_names=tuple(MESH))
    cfg = configs.get_smoke(arch)
    params = lm.abstract_params(cfg, tp=2)
    shape = lm.ShapeSpec("t", SEQ, BATCH, kind)
    batch = lm.input_specs(cfg, shape)
    want = sum(v.numel() // 4 * v.element_size() for v in batch.values())
    want += _tree_bytes(params, param_pspecs(mesh, params, "tp"))
    if kind == "train":     # the AdamW moments, f32 as the parameters
        want += 2 * _tree_bytes(params, opt_pspecs(mesh, params, "tp"))
    if kind == "decode":
        caches = lm.cache_specs(cfg, shape, torch.bfloat16)

        def walk(t):
            return {k: walk(v) for k, v in t.items()} if isinstance(
                t, dict) else _cache_spec(t)
        want += _tree_bytes(caches, walk(caches))
    rec = _pair(dry, arch, kind)[0]
    assert rec["memory"]["argument_bytes"] == want


# ---------------------------------------------------------------------------
# plans and skips
# ---------------------------------------------------------------------------

def test_plan_for_matches_reference(dry):
    assert dry["port"]["plans"] == dry["ref"]["plans"]
    assert len(dry["port"]["plans"]) == 3


def test_long_500k_skips_match_reference(dry):
    assert dry["port"]["full_attention"] == dry["ref"]["full_attention"]
    assert dry["port"]["full_attention"]
    assert dry["port"]["skips"] == dry["ref"]["skips"]


def test_plan_for_refuses_unknown_knobs():
    from repro_torch.launch import dryrun
    with pytest.raises(ValueError, match="unknown plan knob"):
        dryrun.plan_for("qwen2-7b", "train_4k", {"kv_chunks": 1})
    plan = dryrun.plan_for("deepseek-v3-671b", "train_4k", {"accum": 4})
    assert plan.accum == 4 and plan.opt_dtype == "bfloat16"
    cells = dryrun.all_cells()
    assert len(cells) == 10 * 4 + 2
    assert cells[-2:] == [("fege-spinlattice", "md_small"),
                          ("fege-spinlattice", "md_large")]
