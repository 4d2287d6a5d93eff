"""The LM training step: gradient accumulation + AdamW + metrics (port of
``repro.train.train_step``).

Microbatches run one after another (the reference's ``lax.scan``, constant
memory in the accumulation factor): each one's loss and gradient come from
``torch.autograd.grad`` and are summed into ``grad_dtype`` buffers; the
optimizer update happens once per step, through
:func:`repro_torch.train.optimizer.adamw_update`, in place (the step owns
the parameters and moments it is given).  Parameters are the nested dicts
of ``models.lm``; their leaves are taken in ``utils.tree`` order (sorted
keys, as the reference's pytree).

On a mesh (``make_train_step(..., mesh=, mode=)``, the state placed by
:func:`shard_train_state`) the parameters are DTensors placed by the
sharding rules and the moments by ZeRO-1's; the step takes the global
batch as plain tensors (every rank the same), cuts it into microbatches as
the reference's reshape does (microbatch i = global rows [i*m, (i+1)*m))
and splits each microbatch's rows over the data-parallel mesh dimensions.
Each microbatch's gradients come back as DTensors with pending sums
(``Partial``); their local parts are summed into the f32 buffers, and
each is reduced to its parameter's placement once a step, before AdamW:
an all-reduce for a replicated leaf, a reduce-scatter for a sharded one
(its wall seconds are the metric ``reduce_s``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.parallel import sharding as sh
from repro_torch.train.optimizer import OptState, adamw_init, adamw_update
from repro_torch.utils.tree import global_norm, tree_leaves, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    step: int


def init_train_state(params, opt_dtype=torch.float32) -> TrainState:
    """Zero AdamW moments in ``opt_dtype`` for every parameter leaf."""
    return TrainState(params=params,
                      opt=adamw_init(tree_leaves(params), opt_dtype), step=0)


def shard_train_state(state: TrainState, mesh, mode: str = "tp"
                      ) -> TrainState:
    """``state`` (the same full tree on every rank) with each parameter a
    DTensor placed by ``param_shardings`` and each moment by
    ``opt_shardings`` (ZeRO-1), both under ``mode``; every rank keeps its
    own shard, no communication."""
    from torch.distributed.tensor import distribute_tensor
    pl = sh.tree_leaves_of(state.params,
                           sh.param_shardings(mesh, state.params, mode))
    ol = sh.tree_leaves_of(state.params,
                           sh.opt_shardings(mesh, state.params, mode))

    def put(t, p):
        return distribute_tensor(t, mesh, p, src_data_rank=None)
    params = tree_unflatten(state.params, [
        put(t, p) for t, p in zip(tree_leaves(state.params), pl)])
    opt = OptState(mu=[put(t, p) for t, p in zip(state.opt.mu, ol)],
                   nu=[put(t, p) for t, p in zip(state.opt.nu, ol)],
                   count=state.opt.count)
    return TrainState(params=params, opt=opt, step=state.step)


def _split(batch: dict, accum: int) -> list[dict]:
    """The batch's leading dimension cut into ``accum`` microbatches."""
    n = next(iter(batch.values())).shape[0]
    if n % accum:
        raise ValueError(f"batch {n} is not a multiple of accum {accum}")
    m = n // accum
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(accum)]


def make_train_step(
    loss_fn: Callable[[Any, Any], torch.Tensor],
    lr_schedule: Callable[[int], float],
    accum: int = 1,
    adamw_kwargs: dict | None = None,
    grad_dtype=torch.float32,
    mesh=None,
    mode: str = "tp",
):
    """``loss_fn(params, batch)`` -> scalar.  Batch leaves have a leading
    global-batch dimension; with accum > 1 it is split into microbatches
    whose gradients are summed in ``grad_dtype`` and divided by ``accum``
    (with accum = 1 the gradients stay in the parameters' dtype, as in the
    reference).  ``train_step(state, batch)`` -> (new state, metrics
    ``loss``, ``lr``, ``grad_norm``); the state's parameters and moments
    are updated in place.  With a ``mesh`` the state must come from
    :func:`shard_train_state` and the loss runs under ``mode``'s rules."""
    kw = adamw_kwargs or {}

    def grad_fn(leaves, params, mb):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(tree_unflatten(params, ps), mb)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach().float(), [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(ps, grads)]

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        if mesh is not None:
            return _mesh_step(state, leaves, batch)
        if accum == 1:
            loss, grads = grad_fn(leaves, state.params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                     for p in leaves]
            for mb in _split(batch, accum):
                lm, gm = grad_fn(leaves, state.params, mb)
                loss = loss + lm
                for tot, g in zip(grads, gm):
                    tot.add_(g.to(grad_dtype))
                del gm
            loss = loss / accum
            for g in grads:
                g.div_(accum)
        return _update(state, leaves, loss, grads)

    def _update(state, leaves, loss, grads):
        lr = lr_schedule(state.step)
        metrics = {"loss": loss, "lr": lr, "grad_norm": global_norm(grads)}
        _, opt = adamw_update(leaves, grads, state.opt, lr, inplace=True,
                              **kw)
        del grads
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), metrics

    def mesh_grad_fn(leaves, params, mb):
        with sh.use_mesh(mesh, mode):
            ps = [p.detach().requires_grad_(True) for p in leaves]
            loss = loss_fn(tree_unflatten(params, ps), mb)
            if sh.is_dtensor(loss):
                loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        return loss.detach().float(), grads

    def _mesh_step(state, leaves, batch):
        from torch.distributed.tensor import DTensor
        loss = 0.0
        bufs = [None] * len(leaves)     # (local f32 sum, placements)
        for mb in _split(batch, accum):
            lm, gm = mesh_grad_fn(leaves, state.params,
                                  batch_to_mesh(mb, mesh))
            loss = loss + lm
            for i, g in enumerate(gm):
                if g is None:
                    continue
                if bufs[i] is None:
                    bufs[i] = (g.to_local().to(grad_dtype, copy=True),
                               g.placements)
                elif bufs[i][1] != g.placements:
                    raise RuntimeError(
                        f"gradient {i} changed placements between "
                        f"microbatches: {bufs[i][1]} -> {g.placements}")
                else:
                    bufs[i][0].add_(g.to_local().to(grad_dtype))
            del gm
        _sync(leaves[0])
        t0 = time.perf_counter()
        grads = []
        for p, b in zip(leaves, bufs):
            if b is None:
                grads.append(torch.zeros_like(p, dtype=grad_dtype))
                continue
            g = DTensor.from_local(b[0], mesh, b[1], run_check=False,
                                   shape=p.shape, stride=p.stride())
            g = sh.redistribute(g, p.placements)   # the one reduction
            grads.append(g / accum)
        _sync(leaves[0])
        reduce_s = time.perf_counter() - t0
        state, metrics = _update(state, leaves, loss / accum, grads)
        metrics["reduce_s"] = reduce_s
        return state, metrics

    return train_step


def _sync(t) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def batch_to_mesh(batch: dict, mesh) -> dict:
    """The (global, plain) batch's leaves as DTensors split over the
    data-parallel dimensions where their leading dimension divides
    (``launch/mesh.py:batch_shardings``), each rank keeping its rows."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import batch_shardings
    pl = batch_shardings(mesh, batch)
    return {k: distribute_tensor(v, mesh, pl[k], src_data_rank=None)
            for k, v in batch.items()}
