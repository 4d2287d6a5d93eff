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
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

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
):
    """``loss_fn(params, batch)`` -> scalar.  Batch leaves have a leading
    global-batch dimension; with accum > 1 it is split into microbatches
    whose gradients are summed in ``grad_dtype`` and divided by ``accum``
    (with accum = 1 the gradients stay in the parameters' dtype, as in the
    reference).  ``train_step(state, batch)`` -> (new state, metrics
    ``loss``, ``lr``, ``grad_norm``); the state's parameters and moments
    are updated in place."""
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
        lr = lr_schedule(state.step)
        metrics = {"loss": loss, "lr": lr, "grad_norm": global_norm(grads)}
        _, opt = adamw_update(leaves, grads, state.opt, lr, inplace=True,
                              **kw)
        del grads
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), metrics

    return train_step
