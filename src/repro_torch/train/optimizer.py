"""Optimizers built from scratch (port of ``repro.train.optimizer``).

AdamW with dtype-configurable moments (f32 by default) and a global-norm
clip, and SNES (separable natural evolution strategies, the
"neuroevolution" in NEP's name) used by :mod:`repro_torch.core.training`.

Both work on a flat list of tensors, or any NamedTuple of them such as
:class:`repro_torch.core.potential.NEPSpinParams`, and return the same
kind.  The math is the reference's step for step, in the same dtypes: AdamW
updates in f32 whatever the parameters' dtype and stores its moments in the
state's; SNES updates in the parameters' dtype.  No ``torch.optim`` class is
used, so a test can hold each step against the reference on the same
numbers.  ``adamw_update(..., inplace=True)`` (the LM training step) writes
the same values into the parameters and moments it is given, a chunk of
``INPLACE_CHUNK`` elements at a time, so that a multi-billion-parameter
update needs no second copy of the moments.  Its leaves may be DTensors
(a mesh): the global-norm clip then sums over every rank's shard, and each
leaf is updated ZeRO-1 style in its moments' placement.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import sum_squares

INPLACE_CHUNK = 2 ** 24    # elements a step of the in-place update


def _leaves(tree) -> list:
    return list(tree)


def _like(tree, leaves):
    """``leaves`` in the container kind of ``tree``."""
    if hasattr(tree, "_fields"):
        return type(tree)(*leaves)
    return list(leaves)


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: int


def adamw_init(params, dtype=torch.float32) -> OptState:
    z = [torch.zeros(p.shape, dtype=dtype, device=p.device)
         for p in _leaves(params)]
    return OptState(mu=_like(params, z),
                    nu=_like(params, [t.clone() for t in z]), count=0)


def _adamw_leaf(p, g, mu, nu, scale, bc1, bc2, lr, b1, b2, eps,
                weight_decay):
    """One leaf's (or chunk's) update in f32: (new p, mu32, nu32)."""
    f32 = torch.float32
    g = g.to(f32) * scale
    mu32 = mu.to(f32) * b1 + (1 - b1) * g
    nu32 = nu.to(f32) * b2 + (1 - b2) * g * g
    mhat = mu32 / bc1.to(g.device)
    vhat = nu32 / bc2.to(g.device)
    step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(f32)
    return p.to(f32) - lr * step, mu32, nu32


def _inplace_leaf(p, g, mu, nu, scale, hyper) -> None:
    """One leaf's update written into ``p``, ``mu`` and ``nu`` (contiguous
    tensors), ``INPLACE_CHUNK`` elements at a time."""
    views = [p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1)]
    for i in range(0, p.numel(), INPLACE_CHUNK):
        pc, gc, mc, nc = (x[i:i + INPLACE_CHUNK] for x in views)
        q, mu32, nu32 = _adamw_leaf(pc, gc, mc, nc, scale, *hyper)
        pc.copy_(q)
        mc.copy_(mu32)
        nc.copy_(nu32)


def _zero1_leaf(p, g, mu, nu, scale, hyper) -> None:
    """A DTensor leaf's update, ZeRO-1: each rank updates the shard of the
    parameter its moments hold (``opt_shardings``), and the new values
    are redistributed back to the parameter's placement."""
    from torch.distributed.tensor import DTensor
    opl = list(mu.placements)
    mesh = p.device_mesh
    g_l = _to(g, opl).to_local()
    p_l = _to(p, opl).to_local().contiguous().clone()
    _inplace_leaf(p_l, g_l, mu.to_local(), nu.to_local(), scale, hyper)
    new = DTensor.from_local(p_l, mesh, opl, run_check=False,
                             shape=p.shape, stride=p.stride())
    p.to_local().copy_(_to(new, p.placements).to_local())


def _to(x, placements):
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(x.device_mesh, list(placements))


def adamw_update(params, grads, state: OptState, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0, inplace=False):
    """Returns (new_params, new_state).  Math in f32, moments stored in the
    state dtype.  ``inplace`` writes the result into ``params`` and the
    state's moments (contiguous tensors) chunk by chunk, and returns them:
    the same values as out of place (the update is elementwise)."""
    count = state.count + 1
    f32 = torch.float32
    flat_g = [g.detach() for g in _leaves(grads)]
    # global-norm clip
    gnorm = torch.sqrt(sum(sum_squares(g) for g in flat_g))
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    c = torch.tensor(float(count), dtype=f32)
    bc1 = 1 - torch.tensor(b1, dtype=f32) ** c
    bc2 = 1 - torch.tensor(b2, dtype=f32) ** c
    hyper = (bc1, bc2, lr, b1, b2, eps, weight_decay)
    leaves = list(zip(_leaves(params), flat_g, _leaves(state.mu),
                      _leaves(state.nu)))
    if inplace:
        with torch.no_grad():
            for p, g, mu, nu in leaves:
                if hasattr(p, "device_mesh"):
                    _zero1_leaf(p, g, mu, nu, scale, hyper)
                else:
                    _inplace_leaf(p, g, mu, nu, scale, hyper)
        return params, OptState(mu=state.mu, nu=state.nu, count=count)
    newp, newmu, newnu = [], [], []
    for p, g, mu, nu in leaves:
        q, mu32, nu32 = _adamw_leaf(p.detach(), g, mu, nu, scale, *hyper)
        newp.append(q.to(p.dtype))
        newmu.append(mu32.to(mu.dtype))
        newnu.append(nu32.to(nu.dtype))
    return _like(params, newp), OptState(mu=_like(params, newmu),
                                         nu=_like(params, newnu), count=count)


def cosine_schedule(step, *, peak_lr, warmup, total) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""
    step = float(step)
    if step < warmup:
        return peak_lr * (step + 1) / warmup
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return 0.5 * peak_lr * (1 + math.cos(math.pi * frac))


# ---------------------------------------------------------------------------
# SNES - separable natural evolution strategy (the 'NE' in NEP)
# ---------------------------------------------------------------------------

class SNESState(NamedTuple):
    mean: Any       # parameter means
    sigma: Any      # per-parameter standard deviations
    count: int


def snes_init(params, sigma0=0.1) -> SNESState:
    return SNESState(
        mean=params,
        sigma=_like(params, [torch.full(p.shape, sigma0, dtype=p.dtype,
                                        device=p.device)
                             for p in _leaves(params)]),
        count=0)


def snes_ask(state: SNESState, generator: torch.Generator | None,
             popsize: int, *, noise=None):
    """A mirrored population around the mean: ``(pop, noise)``, each a
    list of (2 * (popsize // 2), *shape) tensors, one per leaf.

    The half draws z come from ``generator``, or from ``noise`` (a list of
    (popsize // 2, *shape) tensors, one per leaf, as the caller drew
    them); the population is mean + sigma * [z, -z]."""
    means = _leaves(state.mean)
    half = popsize // 2
    if noise is None:
        noise = [torch.randn((half, *m.shape), generator=generator,
                             dtype=m.dtype, device=m.device) for m in means]
    z = [torch.cat([n.to(m.dtype), -n.to(m.dtype)], 0)
         for n, m in zip(noise, means)]     # mirrored sampling
    pop = [m[None] + s[None] * zz
           for m, s, zz in zip(means, _leaves(state.sigma), z)]
    return pop, z


def snes_member(pop, i: int, like):
    """Member ``i`` of a population from :func:`snes_ask`, in the container
    kind of ``like``."""
    return _like(like, [p[i] for p in pop])


def snes_tell(state: SNESState, noise, fitness: torch.Tensor, *,
              lr_mean=1.0, lr_sigma=None) -> SNESState:
    """``fitness`` (popsize,), lower is better.  Rank-based utilities
    ``max(0, log(pop/2 + 1) - log(rank + 1))``, normalized and centred."""
    pop = fitness.shape[0]
    dt = fitness.dtype
    dev = fitness.device
    if lr_sigma is None:
        lr_sigma = ((3 + torch.log(torch.tensor(float(pop), dtype=dt)))
                    / (5 * torch.sqrt(torch.tensor(float(pop), dtype=dt))))
    order = torch.argsort(fitness, stable=True)           # best first
    ranks = torch.zeros(pop, dtype=dt, device=dev)
    ranks[order] = torch.arange(pop, dtype=dt, device=dev)
    util = torch.clamp(
        torch.log(torch.tensor(pop / 2 + 1, dtype=dt, device=dev))
        - torch.log(ranks + 1), min=0.0)
    util = util / torch.sum(util) - 1.0 / pop
    lr_s = torch.as_tensor(lr_sigma, dtype=dt).to(dev)
    means, sigmas = [], []
    for m, s, z in zip(_leaves(state.mean), _leaves(state.sigma), noise):
        u = util.to(m.dtype).reshape(-1, *([1] * m.dim()))
        gm = torch.sum(u * z, dim=0)
        gs = torch.sum(u * (z * z - 1.0), dim=0)
        means.append(m + lr_mean * s * gm)
        sigmas.append(s * torch.exp(0.5 * lr_s.to(m.dtype) * gs))
    return SNESState(mean=_like(state.mean, means),
                     sigma=_like(state.mean, sigmas), count=state.count + 1)
