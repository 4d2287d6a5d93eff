"""The LM zoo on a mesh (``parallel/sharding.py``, the DTensor training
step, expert-parallel MoE, ``remat="save_collectives"``) on gloo ranks on
the CPU, against the one-rank port and the JAX package.

The module fixture writes the reference's weights (``init_params`` at
tp = 1 and 2), batches and the expert-parallel case's inputs, then spawns
one world of 2 ranks and one of 8 (``tests/torch_mesh_ranks.py``, through
``parallel/ranks.spawn``), each running all of its cases:

(i)   qwen2, mamba2 and moonshot smoke configs, accumulation 2, two AdamW
      steps at a constant 1e-4: ``dp`` over data=2, ``tp`` and ``fsdp``
      over model=2 (moonshot: tp through the EP path, dp through the dense
      dispatch on the mesh, capacity factor 8 so neither drops), against
      the one-rank port step at the same tp and global batch (and qwen2
      with one kv head under tp: the head stays whole while the q heads
      split, so each rank's FA reads it sliced): each step's
      loss and gradient norm within 1e-5 relative, every parameter within
      1e-5 of the largest |parameter| of the one-rank model (AdamW scales
      each entry's step by its own gradient, so a zero-initialised bias
      leaf is itself of the step's size, ~1e-4, and holds last-bit
      gradient differences at that scale), every leaf's first moment
      (0.1 x the gradient, summed over steps) within 1e-4 of its max;
(ii)  that one-rank step (qwen2, tp = 2) against the JAX package's
      ``make_train_step`` on one CPU device, f32, the same weights through
      ``params_from_jax``: 2e-5;
(iii) the reference's expert-parallel case (``tests/test_domain.py``: a
      2 x 4 mesh, 8 experts, top-2, sigmoid router, capacity factor 8) on
      8 ranks: the output within 1e-5 of the port's dense dispatch and of
      the JAX ``apply_moe_dense``, gradients finite and within 1e-5 of
      the dense dispatch's;
(iv)  ``save_collectives`` under a 2-rank tp: gradients equal
      ``remat=True``'s within 1e-6, and the backward issues the
      collectives of a backward with no remat, where ``remat=True``
      re-issues the recomputed blocks' all-reduces;
(v)   decode on the dry run's 2 x 2 x 2 (pod, data, model) mesh of the 8
      ranks, caches placed by ``launch/dryrun.py:cache_shardings``:
      zamba2 (the SSM state and the GQA shared block's KV cache),
      deepseek-v3 (MLA's latent cache, the EP MoE at capacity factor E)
      and qwen2 with one kv head (its cache split on the head dimension:
      the scores summed over the ranks' slices), 3 steps from empty
      caches, logits and caches within 1e-5 of one rank's.
"""
import dataclasses
import json
import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data.tokens import synthetic_batches as j_batches
from repro.models import lm as jlm
from repro.models.config import ArchConfig, MoECfg
from repro.models.moe import apply_moe_dense as j_moe_dense
from repro.models.moe import init_moe as j_init_moe
from repro.train.train_step import init_train_state as j_init_state
from repro.train.train_step import make_train_step as j_make_train_step
from torch_mesh_ranks import (ACCUM, BATCH, DECODE_ARCHS, LR, MESH_CASES,
                              SEQ, STEPS, XENT_CHUNK, case_tp, eight_ranks,
                              split_arch, two_ranks)
from torch_one_thread import one_torch_thread  # noqa: F401

SECONDS = {}


def _dump(d, name, obj):
    with open(os.path.join(d, name), "wb") as f:
        pickle.dump(obj, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.parallel.ranks import spawn
    d = str(tmp_path_factory.mktemp("mesh_train"))
    archs = {arch: {case_tp(shape) for _, a, _, shape in MESH_CASES
                    if a == arch} for _, arch, _, _ in MESH_CASES}
    jparams = {}
    for arch, tps in archs.items():
        name, over = split_arch(arch)
        jcfg = dataclasses.replace(jconfigs.get_smoke(name), **over)
        for tp in tps:
            p = jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=tp)
            jparams[(arch, tp)] = p
            _dump(d, f"params_{arch}_tp{tp}.pkl", jax.tree.map(np.asarray, p))
        gen = j_batches(jcfg, BATCH, SEQ, seed=3)
        _dump(d, f"batches_{arch}.pkl", [next(gen) for _ in range(STEPS)])
    cfgm = ArchConfig(name="t", family="moe", n_layers=1, d_model=32,
                      vocab=64, act="swiglu", dtype="float32",
                      moe=MoECfg(n_experts=8, top_k=2, n_shared=1,
                                 d_ff_expert=16, router="sigmoid",
                                 capacity_factor=8.0))
    pm = j_init_moe(cfgm, jax.random.PRNGKey(0))
    xm = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32))
    y_jax, _ = j_moe_dense(cfgm, pm, xm)
    _dump(d, "ep.pkl", {"params": jax.tree.map(np.asarray, pm),
                        "x": np.asarray(xm), "y_jax": np.asarray(y_jax)})
    for name, fn, n in (("two", two_ranks, 2), ("eight", eight_ranks, 8)):
        t0 = time.perf_counter()
        spawn(fn, n, d, workdir=d)
        SECONDS[name] = time.perf_counter() - t0
    print(f"world seconds: {SECONDS}")
    with open(os.path.join(d, "two.json")) as f:
        two = json.load(f)
    with open(os.path.join(d, "eight.json")) as f:
        eight = json.load(f)
    return {"d": d, "two": two, "eight": eight, "jparams": jparams}


@pytest.mark.parametrize("name", [c[0] for c in MESH_CASES])
def test_mesh_step_matches_one_rank(runs, name):
    r = runs["two"][name]
    assert r["all_dtensor"]
    for got, want in zip(r["rows"], r["ref_rows"]):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), (
                key, got, want)
    assert max(r["param_err"].values()) < 1e-5, sorted(
        r["param_err"].items(), key=lambda kv: -kv[1])[:3]
    assert max(r["mu_err"].values()) < 1e-4, sorted(
        r["mu_err"].items(), key=lambda kv: -kv[1])[:3]


def test_mesh_layouts_are_the_rules(runs):
    """tp splits heads / ffn / vocab over "model"; fsdp splits d_model;
    dp keeps every leaf whole."""
    two = runs["two"]
    assert two["qwen2-dp"]["placements"] == ["(Replicate(),)"]
    assert "(Shard(dim=1),)" in two["qwen2-fsdp"]["placements"]
    for name in ("qwen2-tp", "mamba2-tp", "moonshot-tp-ep",
                 "qwen2-mqa-tp"):
        assert "(Replicate(),)" in two[name]["placements"]
        assert any("Shard" in p for p in two[name]["placements"])


def test_one_rank_step_matches_jax(runs):
    """(ii): the one-rank port step of the qwen2 tp case against the JAX
    package's make_train_step on the same weights and batches."""
    from repro.train.optimizer import adamw_init  # noqa: F401
    arch = "qwen2-7b"
    jcfg = jconfigs.get_smoke(arch)
    step = jax.jit(j_make_train_step(
        jlm.make_loss_fn(jcfg, remat=True, xent_chunk=XENT_CHUNK),
        lambda s: jnp.float32(LR), accum=ACCUM))
    state = j_init_state(runs["jparams"][(arch, 2)])
    with open(os.path.join(runs["d"], f"batches_{arch}.pkl"), "rb") as f:
        batches = pickle.load(f)
    rows = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        rows.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    for got, want in zip(runs["two"]["qwen2-tp"]["one_rank_rows"], rows):
        for key in ("loss", "grad_norm"):
            assert abs(got[key] - want[key]) <= 2e-5 * abs(want[key]), (
                key, got, want)
    port = np.load(os.path.join(runs["d"], "one_rank_qwen2_tp2.npz"))
    flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
    want = {"/" + "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}
    assert set(want) == set(port.files)
    scale = max(float(np.abs(v).max()) for v in want.values())
    worst = max(float(np.abs(port[k] - v).max()) for k, v in want.items())
    assert worst < 2e-5 * scale, worst / scale


def test_ep_matches_dense_dispatch_and_jax(runs):
    e = runs["eight"]
    assert e["expert_placements"] == "(Shard(dim=0), Shard(dim=0))"
    assert e["dense_dropped"] == 0 and not any(e["ep_dropped"])
    assert e["y_vs_dense"] < 1e-5
    assert e["y_vs_jax"] < 1e-5
    assert e["aux"] == 0.0                         # sigmoid: aux-free


def test_ep_gradients_finite_and_match_dense(runs):
    e = runs["eight"]
    assert e["grads_finite"]
    assert max(e["grad_vs_dense"].values()) < 1e-5, e["grad_vs_dense"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_on_a_mesh_matches_one_rank(runs, arch):
    """(v): decode steps on DTensors (the cache writes into each rank's
    shard, attention on each rank's heads) as on one rank."""
    e = runs["eight"]["decode"][arch]
    assert e["logits"] < 1e-5 and e["caches"] < 1e-5, e


def test_save_collectives_reuses_block_all_reduces(runs):
    s = runs["two"]["save_collectives"]
    assert s["grad_err_vs_remat"] < 1e-6
    c = s["backward_collectives"]
    assert c["save_collectives"] == c["False"], c
    extra = c["True"].get("all_reduce", 0) - c["False"].get("all_reduce", 0)
    assert extra >= s["n_layers"], c


def test_mesh_launcher_matches_one_device(tmp_path):
    """``launch/train.py --mesh data=2 --sharding dp --backend gloo
    --device cpu`` (two spawned ranks) against the one-device run."""
    from repro_torch.launch.train import parse_args, train_lm
    base = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16", "--log-every", "1"]
    one = train_lm(parse_args(base))
    two = train_lm(parse_args(base + ["--mesh", "data=2", "--sharding",
                                      "dp", "--backend", "gloo"]))
    assert two["backend"] == "gloo" and two["mesh"] == {"data": 2}
    assert two["peak_gib"] == [None, None]
    for a, b in zip(two["rows"], one["rows"]):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), (key, a, b)
        assert a["reduce_s"] >= 0
