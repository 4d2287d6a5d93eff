"""The rank bodies of ``tests/test_torch_mesh_train.py``: gloo ranks on the
CPU, spawned by ``repro_torch.parallel.ranks.spawn``.  They import torch
and the port only (no JAX): the reference's weights, batches and outputs
come in as numpy files that the test module wrote, and each world's
results go back as one JSON file and the one-rank step's final
parameters as an ``.npz``.
"""
import dataclasses
import json
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

ACCUM, BATCH, SEQ, STEPS, XENT_CHUNK = 2, 4, 32, 2, 12
LR = 1e-4
# (name, arch, sharding, mesh); the MoE cases at capacity factor 8 (the
# EP path's per-rank capacity and the dense dispatch's global one then
# drop nothing), moonshot's tp taking EP and its dp the dense dispatch
MESH_CASES = (("qwen2-dp", "qwen2-7b", "dp", {"data": 2}),
              ("qwen2-tp", "qwen2-7b", "tp", {"model": 2}),
              ("qwen2-fsdp", "qwen2-7b", "fsdp", {"model": 2}),
              ("mamba2-dp", "mamba2-2.7b", "dp", {"data": 2}),
              ("mamba2-tp", "mamba2-2.7b", "tp", {"model": 2}),
              ("mamba2-fsdp", "mamba2-2.7b", "fsdp", {"model": 2}),
              ("moonshot-tp-ep", "moonshot-v1-16b-a3b", "tp", {"model": 2}),
              ("moonshot-dp", "moonshot-v1-16b-a3b", "dp", {"data": 2}),
              ("qwen2-mqa-tp", "qwen2-7b:mqa", "tp", {"model": 2}))
# qwen2 with one kv head: kv_heads <= tp keeps it whole (replicated) while
# the 4 q heads split 2 a rank, so each rank's FA reads the kv head sliced
# for its own q heads and returns that head's gradient as a partial sum
VARIANTS = {"mqa": {"kv_heads": 1}}


def split_arch(arch):
    """(registry name, field overrides) of a case's arch."""
    name, _, variant = arch.partition(":")
    return name, VARIANTS.get(variant, {})


def case_cfg(arch):
    from repro_torch import configs
    name, over = split_arch(arch)
    cfg = dataclasses.replace(configs.get_smoke(name), **over)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def case_tp(shape) -> int:
    return shape.get("model", 1)


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(list(shape.values())))
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape.values())),
                      mesh_dim_names=tuple(shape))


def _load(d, name):
    with open(os.path.join(d, name), "rb") as f:
        return pickle.load(f)


def _names(tree, prefix=""):
    return [n for k in sorted(tree) for n in (
        _names(tree[k], f"{prefix}/{k}") if isinstance(tree[k], dict)
        else [f"{prefix}/{k}"])]


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _train(cfg, params, batches, mesh=None, mode="tp"):
    """STEPS steps of make_train_step from ``params``: (metrics rows,
    state)."""
    from repro_torch.models import lm
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              shard_train_state)
    state = init_train_state(params)
    if mesh is not None:
        state = shard_train_state(state, mesh, mode)
    step = make_train_step(lm.make_loss_fn(cfg, remat=True,
                                           xent_chunk=XENT_CHUNK),
                           lambda s: LR, accum=ACCUM, mesh=mesh, mode=mode)
    rows = []
    for b in batches:
        state, m = step(state, b)
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])})
    return rows, state


def _mesh_case(d, name, arch, mode, shape):
    """One (i) case on this rank: the one-rank step and the mesh step
    from the reference's weights at the mesh's tp on the same batches;
    rank 0 records the errors."""
    from repro_torch.data.tokens import to_tensors
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_leaves
    cfg = case_cfg(arch)
    tp = case_tp(shape)
    tree = _load(d, f"params_{arch}_tp{tp}.pkl")
    batches = [to_tensors(b, "cpu")
               for b in _load(d, f"batches_{arch}.pkl")]
    ref_rows, ref = _train(cfg, lm.params_from_jax(cfg, tree, device="cpu"),
                           batches)
    rows, got = _train(cfg, lm.params_from_jax(cfg, tree, device="cpu"),
                       batches, _mesh(shape), mode)
    want_p = tree_leaves(ref.params)
    got_p = [_full(x) for x in tree_leaves(got.params)]
    scale = max(float(w.abs().max()) for w in want_p)
    names = _names(ref.params)
    param_err = {n: float((g - w).abs().max()) / scale
                 for n, g, w in zip(names, got_p, want_p)}
    mu_err = {n: float((_full(g) - w).abs().max())
              / max(float(w.abs().max()), 1e-30)
              for n, g, w in zip(names, got.opt.mu, ref.opt.mu)}
    placed = sorted({str(tuple(x.placements))
                     for x in tree_leaves(got.params)})
    out = {"rows": rows, "ref_rows": ref_rows, "param_err": param_err,
           "mu_err": mu_err, "placements": placed,
           "all_dtensor": all(hasattr(x, "placements")
                              for x in tree_leaves(got.params))}
    if name == "qwen2-tp" and dist.get_rank() == 0:
        np.savez(os.path.join(d, "one_rank_qwen2_tp2.npz"),
                 **{n: w.numpy() for n, w in zip(names, want_p)})
        out["one_rank_rows"] = ref_rows
    return out


class CollectiveCount(TorchDispatchMode):
    """Counts the functional collectives dispatched while it is active
    (those served from a selective checkpoint's cache are not)."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", "") == "_c10d_functional":
            name = func.__name__.split(".")[0]
            self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _save_collectives_case(d):
    """(iv) on a 2-rank tp mesh: the gradients of one loss under
    remat=False, True and "save_collectives", and the collectives each
    backward issues."""
    from repro_torch.data.tokens import to_tensors
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.train_step import batch_to_mesh
    from repro_torch.utils.tree import tree_leaves, tree_unflatten
    from torch.distributed.tensor import distribute_tensor
    cfg = case_cfg("qwen2-7b")
    mesh = _mesh({"model": 2})
    params = lm.params_from_jax(cfg, _load(d, "params_qwen2-7b_tp2.pkl"),
                                device="cpu")
    batch = batch_to_mesh(to_tensors(_load(d, "batches_qwen2-7b.pkl")[0],
                                     "cpu"), mesh)
    pl = sh.tree_leaves_of(params, sh.param_shardings(mesh, params, "tp"))
    leaves = [distribute_tensor(t, mesh, p, src_data_rank=None)
              for t, p in zip(tree_leaves(params), pl)]
    grads, counts = {}, {}
    for remat in (False, True, "save_collectives"):
        loss_fn = lm.make_loss_fn(cfg, remat=remat, xent_chunk=XENT_CHUNK)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        with sh.use_mesh(mesh, "tp"):
            loss = loss_fn(tree_unflatten(params, ps), batch).full_tensor()
            count = CollectiveCount()
            with count:
                g = torch.autograd.grad(loss, ps)
        grads[str(remat)] = [x.full_tensor() for x in g]
        counts[str(remat)] = count.n
    err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(grads["save_collectives"], grads["True"]))
    return {"grad_err_vs_remat": err, "backward_collectives": counts,
            "n_layers": cfg.n_layers}


def two_ranks(rank, d):
    """World 2: every (i) case, then (iv)."""
    torch.set_num_threads(1)
    res = {name: _mesh_case(d, name, arch, mode, shape)
           for name, arch, mode, shape in MESH_CASES}
    res["save_collectives"] = _save_collectives_case(d)
    if rank == 0:
        with open(os.path.join(d, "two.json"), "w") as f:
            json.dump(res, f)


# (v) decode on the dry run's 2 x 2 x 2 (pod, data, model) mesh: the
# hybrid (SSM state and GQA shared block), MLA with the EP MoE, and one kv
# head (the cache then splits its head dimension over "model")
DECODE_ARCHS = ("zamba2-2.7b", "deepseek-v3-671b", "qwen2-7b:mqa")
DECODE_B, DECODE_T, DECODE_STEPS = 8, 16, 3


def _decode_case(arch):
    """(v) ``DECODE_STEPS`` decode steps of the smoke config from empty
    caches (seeded port weights at tp = 2) on the mesh, parameters placed
    by the tp rules and caches by ``launch/dryrun.py:cache_shardings``,
    against the same steps on one rank: the largest logit error over the
    largest |logit|, and every cache leaf's."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import cache_shardings, place_tree
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.train_step import batch_to_mesh
    name, over = split_arch(arch)
    cfg = dataclasses.replace(configs.get_smoke(name), **over)
    if cfg.moe is not None:   # every token kept on both paths
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    params = lm.init_params(cfg, torch.Generator().manual_seed(5), tp=2,
                            device="cpu")
    one = tfm.init_caches(cfg, DECODE_B, DECODE_T, torch.float32, "cpu")
    mesh = _mesh({"pod": 2, "data": 2, "model": 2})
    mine = place_tree(_map(one, torch.clone), cache_shardings(mesh, one),
                      mesh)
    p_mesh = place_tree(params, sh.param_shardings(mesh, params, "tp"),
                        mesh)
    fn = lm.make_decode_fn(cfg)
    g = torch.Generator().manual_seed(6)
    err = 0.0
    with torch.no_grad():
        for step in range(DECODE_STEPS):
            batch = {"token": torch.randint(0, cfg.vocab, (DECODE_B, 1),
                                            generator=g, dtype=torch.int32),
                     "position": torch.full((DECODE_B,), step,
                                            dtype=torch.int32)}
            want, one = fn(params, one, batch)
            with sh.use_mesh(mesh, "tp"):
                got, mine = fn(p_mesh, mine, batch_to_mesh(batch, mesh))
            err = max(err, float((_full(got) - want).abs().max())
                      / float(want.abs().max()))
    cache_err = max(float((_full(a).float() - b.float()).abs().max())
                    for a, b in zip(_leaves(mine), _leaves(one)))
    return {"logits": err, "caches": cache_err}


def _decode_cases():
    """(v) under ``launch/dryrun.py:card_dtensor`` (the dry run's DTensor
    settings: the redistribution planner's memo, the all-to-all of a
    Shard -> Shard move), as the dry run counts it."""
    from repro_torch.launch.dryrun import card_dtensor
    with card_dtensor():
        return {arch: _decode_case(arch) for arch in DECODE_ARCHS}


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree):
    return [x for k in sorted(tree) for x in (
        _leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def eight_ranks(rank, d):
    """World 8: (iii), the reference's expert-parallel case on a 2 x 4
    ("data", "model") mesh, against the dense dispatch; then (v)."""
    from repro_torch.models import moe
    from repro_torch.models.config import ArchConfig, MoECfg
    from repro_torch.parallel import sharding as sh
    from torch.distributed.tensor import distribute_tensor
    torch.set_num_threads(1)
    cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=32,
                     vocab=64, act="swiglu", dtype="float32",
                     moe=MoECfg(n_experts=8, top_k=2, n_shared=1,
                                d_ff_expert=16, router="sigmoid",
                                capacity_factor=8.0))
    ep = _load(d, "ep.pkl")
    p = {k: torch.from_numpy(v) for k, v in ep["params"].items()}
    x = torch.from_numpy(ep["x"])
    pr = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    moe.DROPS = []
    y_dense, _ = moe.apply_moe_dense(cfg, pr, x)
    keys = sorted(pr)
    g_dense = torch.autograd.grad((y_dense ** 2).sum(),
                                  [pr[k] for k in keys])
    dense_drops = sum(moe.DROPS)
    mesh = _mesh({"data": 2, "model": 4})
    pl = sh.param_shardings(mesh, {"moe": p}, "tp")["moe"]
    dp = {k: distribute_tensor(v, mesh, pl[k],
                               src_data_rank=None).requires_grad_(True)
          for k, v in p.items()}
    xd = distribute_tensor(x, mesh, sh.placements(mesh, sh.resolve_spec(
        mesh, ("batch",), tuple(x.shape[:1]))), src_data_rank=None)
    moe.DROPS = []
    with sh.use_mesh(mesh, "tp"):
        y_ep, aux = moe.apply_moe(cfg, dp, xd)
        g_ep = torch.autograd.grad((y_ep ** 2).sum().full_tensor(),
                                   [dp[k] for k in keys])
    ep_drops = [None] * dist.get_world_size()
    dist.all_gather_object(ep_drops, sum(moe.DROPS))
    moe.DROPS = None
    y = y_ep.full_tensor().detach()
    y_dense = y_dense.detach()
    g_ep = [g.full_tensor() for g in g_ep]
    out = {
        "y_vs_dense": float((y - y_dense).abs().max())
        / float(y_dense.abs().max()),
        "y_vs_jax": float((y.numpy() - ep["y_jax"]).__abs__().max())
        / float(np.abs(ep["y_jax"]).max()),
        "grad_vs_dense": {k: float((a - b).abs().max())
                          / max(float(b.abs().max()), 1e-30)
                          for k, a, b in zip(keys, g_ep, g_dense)},
        "grads_finite": all(bool(torch.isfinite(g).all()) for g in g_ep),
        "aux": float(aux.full_tensor()),
        "dense_dropped": dense_drops, "ep_dropped": ep_drops,
        "expert_placements": str(tuple(dp["wi"].placements)),
        "decode": _decode_cases(),
    }
    if rank == 0:
        with open(os.path.join(d, "eight.json"), "w") as f:
            json.dump(out, f)
