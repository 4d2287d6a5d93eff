"""Shared neural building blocks (port of ``repro.models.common``).

Parameters are plain tensors; random ones are drawn from an explicit
``torch.Generator``.  ``chunked_xent`` is the training loss over a large
vocabulary.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


DRAW_CHUNK = 2 ** 28    # elements of f32 drawn at once for a cast leaf


def normal(generator, shape, scale, dtype, device) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape``, drawn in f32 from ``generator`` and
    cast to ``dtype``.  A leaf cast from more than ``DRAW_CHUNK`` f32
    values is drawn in blocks of leading indices of at most that many
    values (a stacked MoE leaf of moonshot's is 8.7 G values: 35 GB in
    f32), or an index at a time where one index holds more.  On the meta
    device only the shape is made."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.float32 or math.prod(shape) <= DRAW_CHUNK:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dtype)
    rows = DRAW_CHUNK // math.prod(shape[1:])
    out = torch.empty(shape, dtype=dtype, device=device)
    if rows == 0:
        for i in range(shape[0]):
            out[i] = normal(generator, shape[1:], scale, dtype, device)
        return out
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        out[i:i + n] = normal(generator, (n, *shape[1:]), scale, dtype,
                              device)
    return out


def rmsnorm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x.to(dt) * w.to(dt)


def layernorm(x, w, b, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return x.to(dt) * w.to(dt) + b.to(dt)


def apply_norm(cfg, p, x):
    """p is the dict produced by init_norm ({'_w'} or {'_w','_b'})."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["_w"], p["_b"])
    return rmsnorm(x, p["_w"])


def init_norm(cfg, d, dtype, device):
    if cfg.norm == "layernorm":
        return {"_w": torch.ones((d,), dtype=dtype, device=device),
                "_b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"_w": torch.ones((d,), dtype=dtype, device=device)}


def _relu2(x):
    return torch.square(F.relu(x))


def act_fn(name: str):
    if name == "swiglu":  # handled by caller (gated)
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu
    if name == "relu2":   # squared ReLU (nemotron/minitron)
        return _relu2
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float) -> np.ndarray:
    """Inverse frequencies in numpy float64, then cast to f32 (as the
    reference computes them: f32 parity depends on it)."""
    return (1.0 / (theta ** (np.arange(0, hd, 2) / hd))).astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int.  Rotates interleaved pairs
    (x[..., ::2], x[..., 1::2]), not the halves of HF's ``rotate_half``.
    (The reference's partial ``rot_dim`` has no caller: MLA passes its
    rope slice whole.)"""
    freqs = torch.from_numpy(rope_freqs(x.shape[-1], theta)).to(x.device)
    ang = positions[..., None].float() * freqs              # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., ::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, generator, d: int, dff: int, dtype, device, *, lead=()):
    """``lead`` prepends stacked-layer dimensions."""
    s_in, s_out = (2.0 / d) ** 0.5, (2.0 / dff) ** 0.5
    p = {"wi": normal(generator, (*lead, d, dff), s_in, dtype, device),
         "wo": normal(generator, (*lead, dff, d), s_out, dtype, device)}
    if cfg.act == "swiglu":
        p["wg"] = normal(generator, (*lead, d, dff), s_in, dtype, device)
    return p


def apply_mlp(cfg, p, x):
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = act_fn(cfg.act)(x @ p["wi"])
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _xent_sum(logits_fn, hb, tb, mb):
    """Summed masked nll of one chunk: logits in f32, logsumexp - gold (a
    ``record_function`` range, which ``launch/profile_lm.py --train``
    reads)."""
    with torch.profiler.record_function("chunked_xent"):
        logits = logits_fn(hb).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, tb.long()[:, None])[:, 0]
        return torch.sum((lse - gold) * mb.float())


def chunked_xent(logits_fn, h: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """Cross-entropy over huge vocabularies without materialising the full
    (tokens, V) logits: ``chunk`` rows at a time, each chunk's logits ->
    logsumexp -> nll under ``torch.utils.checkpoint`` (non-reentrant), so
    the backward keeps only the chunk's hidden rows and recomputes its
    logits (qwen2's V = 152,064 makes one 2,048-row chunk of f32 logits
    1.25 GB).  h: (T, d), targets: (T,), mask: (T,); logits_fn: (n, d) ->
    (n, V).  The mean is over max(sum(mask), 1), as in the reference."""
    from repro_torch.parallel.sharding import is_dtensor
    if is_dtensor(h):
        return _chunked_xent_mesh(logits_fn, h, targets, mask, chunk)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(_xent_sum, logits_fn, h[sl], targets[sl],
                                   mask[sl], use_reentrant=False)
    return total / torch.clamp(torch.sum(mask.float()), min=1.0)


def _xent_sum_sharded(logits_fn, hb, tb, mb):
    """:func:`_xent_sum` on DTensors whose logits may be split over the
    vocabulary: the log-sum-exp from a gathered row max and a summed
    exp, and the gold logit as a masked sum (a gather across a split
    vocabulary has no sharding rule), so no rank holds a whole row."""
    with torch.profiler.record_function("chunked_xent"):
        logits = logits_fn(hb).float()
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(tb.long()[..., None] == vocab, logits,
                           0.0).sum(-1)
        return torch.sum((lse - gold) * mb.float())


def _chunked_xent_mesh(logits_fn, h, targets, mask, chunk):
    """:func:`chunked_xent` on a mesh: the rows are cut into the shards of
    their data-parallel split, and each chunk takes ``chunk`` rows of
    every shard at once, so a chunk never crosses a shard (the rows of
    a shard stay on their rank)."""
    from torch.distributed.tensor import Shard
    n = math.prod(int(sz) for p, sz in zip(h.placements,
                                           h.device_mesh.mesh.shape)
                  if isinstance(p, Shard) and p.dim == 0)
    t = h.shape[0]
    h3 = h.view(n, t // n, h.shape[1])
    t3, m3 = targets.view(n, t // n), mask.view(n, t // n)
    total = None
    for c0 in range(0, t // n, chunk):
        sl = slice(c0, c0 + chunk)
        part = checkpoint(_xent_sum_sharded, logits_fn, h3[:, sl],
                          t3[:, sl], m3[:, sl], use_reentrant=False)
        total = part if total is None else total + part
    return total / torch.clamp(torch.sum(mask.float()), min=1.0)
