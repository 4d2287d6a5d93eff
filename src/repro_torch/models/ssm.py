"""Mamba-2 (state-space duality / SSD) blocks (port of ``repro.models.ssm``).

Training and prefill run the chunked SSD algorithm through the hand-written
chunk kernel (:func:`repro_torch.kernels.ssd.ops.ssd_chunked_kernel`); under
autograd its chunk step is the kernels' Function, whose backward is the SSD
backward kernel (the reference differentiates its jnp ``ssd_chunked``).
Decode keeps a constant-size recurrent state and runs no kernel.
``ssd_chunked`` (the reference's plain chunked form) and ``ssd_reference``
(the per-step recurrence) are kept as oracles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd.ops import ssd_chunked_kernel
from repro_torch.models.common import normal, rmsnorm
from repro_torch.parallel.sharding import (heads_local_map, is_dtensor,
                                           keep_shards, redistribute)


def ssm_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return d_in, n_heads


def init_mamba2(cfg, generator, dtype, device, *, lead=()):
    """One block's weights; ``lead`` prepends stacked-layer dimensions."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh = ssm_dims(cfg)
    g, n = s.n_groups, s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    # in_proj emits [z (gate), x, B, C, dt]
    return {
        "in_proj": normal(generator, (*lead, d, 2 * d_in + 2 * g * n + nh),
                          (1.0 / d) ** 0.5, dtype, device),
        "conv_w": normal(generator, (*lead, s.conv_width, d_in + 2 * g * n),
                         0.5, dtype, device),
        "conv_b": torch.zeros((*lead, d_in + 2 * g * n), dtype=dtype,
                              device=device),
        "a_log": a_log.expand(*lead, nh).clone(),
        "dt_bias": torch.zeros((*lead, nh), **f32),
        "d_skip": torch.ones((*lead, nh), **f32),
        "norm_w": torch.ones((*lead, d_in), dtype=dtype, device=device),
        "out_proj": normal(generator, (*lead, d_in, d), (1.0 / d_in) ** 0.5,
                           dtype, device),
    }


def _split_proj(cfg, proj):
    s = cfg.ssm
    d_in, nh = ssm_dims(cfg)
    g, n = s.n_groups, s.d_state
    return torch.split(proj, [d_in, d_in + 2 * g * n, nh], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv1d as the sum of K shifted products.  x: (B,S,C);
    w: (K, C).  (Not ``F.conv1d``: on the card cuDNN runs f32 convolutions
    in TF32 by default.)"""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def ssd_chunked(x, dt, a, b, c, d_skip, chunk: int):
    """Chunked SSD scan in plain torch (the reference's ``ssd_chunked``).

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); a: (H,) negative decay;
    b, c: (B, S, G, N); returns y: (B, S, H, P).
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError("seq must be a chunk multiple")

    xr = x.reshape(bs, nc, chunk, h, p)
    dtr = dt.reshape(bs, nc, chunk, h)
    br = torch.repeat_interleave(b, rep, dim=2).reshape(bs, nc, chunk, h, n)
    cr = torch.repeat_interleave(c, rep, dim=2).reshape(bs, nc, chunk, h, n)

    cum = torch.cumsum(dtr * a, dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,L,L,H)
    li = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(li[None, None, :, :, None], seg, -1e30)
    decay = torch.exp(seg)
    cb = torch.einsum("bnlhs,bnmhs->bnlmh", cr, br)
    y_intra = torch.einsum("bnlmh,bnmhp->bnlhp",
                           cb * decay.to(x.dtype) * dtr.to(x.dtype)[:, :,
                                                                   None],
                           xr)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bnlh,bnlhs,bnlhp->bnhsp",
                          decay_to_end.to(x.dtype) * dtr.to(x.dtype), br, xr)
    chunk_decay = torch.exp(cum[:, :, -1, :])

    prev = torch.empty_like(states)
    run = torch.zeros((bs, h, n, p), dtype=x.dtype, device=x.device)
    for i in range(nc):
        prev[:, i] = run
        run = states[:, i] + chunk_decay[:, i, :, None, None].to(
            states.dtype) * run

    y_inter = torch.einsum("bnlhs,bnlh,bnhsp->bnlhp", cr,
                           torch.exp(cum).to(x.dtype), prev)
    y = (y_intra + y_inter).reshape(bs, s, h, p)
    return y + d_skip[None, None, :, None].to(x.dtype) * x


def ssd_reference(x, dt, a, b, c, d_skip):
    """Naive per-step recurrence (oracle for the chunked form + kernel)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    br = torch.repeat_interleave(b, rep, dim=2)
    cr = torch.repeat_interleave(c, rep, dim=2)
    state = torch.zeros((bs, h, n, p), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t]
        dec = torch.exp(dtt * a[None, :])[..., None, None]
        state = state * dec + (dtt[..., None, None].to(x.dtype)
                               * br[:, t, :, :, None] * x[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", cr[:, t], state))
    y = torch.stack(ys, dim=1)
    return y + d_skip[None, None, :, None].to(x.dtype) * x


def apply_mamba2(cfg, p, x):
    """Full Mamba-2 block (training and prefill) through the SSD chunk
    kernels.  x: (B, S, d)."""
    s = cfg.ssm
    d_in, nh = ssm_dims(cfg)
    g, n = s.n_groups, s.d_state
    proj = x @ p["in_proj"]
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if is_dtensor(proj):
        # [z, x, B, C, dt] split over "model" is not head-aligned: gather
        # it (an all-gather under tp) and the conv's small weights, as
        # GSPMD would
        proj = redistribute(proj, keep_shards(proj, (0,)))
        conv_w = redistribute(conv_w, keep_shards(conv_w))
        conv_b = redistribute(conv_b, keep_shards(conv_b))
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = F.silu(_causal_conv(xbc, conv_w, conv_b))
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    bs, sl, _ = x.shape
    xh = xs.view(bs, sl, nh, s.head_dim)      # strided views, no copies
    bh = b.view(bs, sl, g, n)
    ch = c.view(bs, sl, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    if is_dtensor(xh):      # each rank's heads, with their groups' B / C
        y = heads_local_map(
            lambda *t: ssd_chunked_kernel(*t, s.chunk),
            (xh, dt, a, bh, ch, p["d_skip"]),
            (("h", 2, True), ("h", 2, True), ("h", 0, False),
             ("g", 2, True), ("g", 2, True), ("h", 0, False)))
    else:
        y = ssd_chunked_kernel(xh, dt, a, bh, ch, p["d_skip"], s.chunk)
    y = y.reshape(bs, sl, d_in)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    return y @ p["out_proj"]


def init_mamba2_cache(cfg, bsz: int, dtype=torch.float32, device="cuda",
                      *, lead=()):
    s = cfg.ssm
    d_in, nh = ssm_dims(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "state": torch.zeros((*lead, bsz, nh, s.d_state, s.head_dim), **kw),
        "conv": torch.zeros((*lead, bsz, s.conv_width - 1,
                             d_in + 2 * s.n_groups * s.d_state), **kw),
    }


def apply_mamba2_decode(cfg, p, x, cache):
    """One-token decode: O(1) state update, no kernel.  x: (B, 1, d).
    Returns (out, new cache) with fresh ``state`` and ``conv`` tensors."""
    s = cfg.ssm
    d_in, nh = ssm_dims(cfg)
    g, n = s.n_groups, s.d_state
    proj = x[:, 0] @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    # causal conv over (cached last K-1 inputs + current)
    cdt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    hist = torch.cat([cache["conv"].to(cdt), xbc[:, None, :].to(cdt)], dim=1)
    conv_out = torch.sum(hist * p["conv_w"][None], dim=1) + p["conv_b"]
    xbc_a = F.silu(conv_out)
    new_conv = hist[:, 1:].to(cache["conv"].dtype)
    xs, b, c = torch.split(xbc_a, [d_in, g * n, g * n], dim=-1)
    xh = xs.reshape(-1, nh, s.head_dim)
    bh = torch.repeat_interleave(b.reshape(-1, g, n), nh // g, dim=1)
    ch = torch.repeat_interleave(c.reshape(-1, g, n), nh // g, dim=1)
    dtv = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    dec = torch.exp(dtv * a[None, :])[..., None, None].to(
        cache["state"].dtype)
    state = cache["state"] * dec + (dtv[..., None, None].to(x.dtype)
                                    * bh[..., :, None] * xh[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", ch, state)
    y = y + p["d_skip"][None, :, None].to(x.dtype) * xh
    y = y.reshape(-1, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_w"])
    out = (y @ p["out_proj"]).to(x.dtype)
    return out[:, None, :], {"state": state.to(cache["state"].dtype),
                             "conv": new_conv}
