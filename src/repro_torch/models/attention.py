"""Grouped-query attention (port of the GQA half of
``repro.models.attention``; MLA waits for its slice).

Prefill runs the hand-written flash-attention kernel
(:func:`repro_torch.kernels.attention.kernel.flash_attention_fwd`) where the
reference calls ``chunked_attention``; at positions 0..S-1 with no KV mask
the two compute the same function, and ``chunked_attention`` is kept as a
plain function that the tests hold the kernel path against.  Decode attends
one query against a KV cache that is updated in place.  Head dimensions are
padded up to a multiple of the tensor-parallel degree as in the reference,
so parameter shapes match it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_fwd
from repro_torch.models.common import apply_rope, normal

NEG_INF = -1e30


def pad_heads(h: int, tp: int) -> int:
    return -(-h // tp) * tp


def init_gqa(cfg, generator, tp: int, dtype, device):
    d, hd = cfg.d_model, cfg.hd
    hp = pad_heads(cfg.n_heads, tp)
    # kv heads below the TP degree stay logical; above it they are padded
    kvp = cfg.kv_heads if cfg.kv_heads <= tp else pad_heads(cfg.kv_heads, tp)
    s = (1.0 / d) ** 0.5
    p = {
        "wq": normal(generator, (d, hp, hd), s, dtype, device),
        "wk": normal(generator, (d, kvp, hd), s, dtype, device),
        "wv": normal(generator, (d, kvp, hd), s, dtype, device),
        "wo": normal(generator, (hp, hd, d), s, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hp, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kvp, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kvp, hd), dtype=dtype, device=device)
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _out(o, wo):
    """einsum('bshk,hkd->bsd') as one matrix product."""
    h, k, d = wo.shape
    return o.flatten(-2) @ wo.reshape(h * k, d)


def _qkv(cfg, p, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q, k, v, q_pos, k_pos, window: int = 0,
                      kv_chunk: int = 1024, k_valid=None):
    """Flash-style attention in plain torch: a loop over KV chunks with
    running softmax statistics (the reference's ``chunked_attention``).

    q: (B, S, H, hd);  k/v: (B, T, Hkv, hd);  *_pos: (B, S)/(B, T).
    Causal: attends where k_pos <= q_pos (and > q_pos - window if SWA).
    """
    b, s, h, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    rep = h // hkv
    qf = (q * hd ** -0.5).float()
    kval = (k_valid if k_valid is not None else
            torch.ones((b, t), dtype=torch.bool, device=q.device))
    m_run = torch.full((b, h, s), NEG_INF, device=q.device)
    l_run = torch.zeros((b, h, s), device=q.device)
    acc = torch.zeros((b, h, s, vd), device=q.device)
    for c0 in range(0, t, kv_chunk):
        kb = torch.repeat_interleave(k[:, c0:c0 + kv_chunk], rep, dim=2)
        vb = torch.repeat_interleave(v[:, c0:c0 + kv_chunk], rep, dim=2)
        pb, mb = k_pos[:, c0:c0 + kv_chunk], kval[:, c0:c0 + kv_chunk]
        sco = torch.einsum("bshk,bchk->bhsc", qf, kb.float())
        ok = (pb[:, None, None, :] <= q_pos[:, None, :, None]) & \
            mb[:, None, None, :]
        if window:
            ok &= pb[:, None, None, :] > (q_pos[:, None, :, None] - window)
        sco = torch.where(ok, sco, NEG_INF)
        m_new = torch.maximum(m_run, sco.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        prob = torch.exp(sco - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum("bhsc,bchk->bhsk", prob,
                                                    vb.float())
        l_run = l_run * alpha + prob.sum(dim=-1)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)          # (B,S,H,hd)


def apply_gqa(cfg, p, x, positions):
    """Prefill self-attention through the flash kernel.  ``positions`` must
    be 0..S-1 in every row (the kernel's causal and window masks use row
    indices).  Returns (out, (k, v))."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = flash_attention_fwd(q, k, v, causal=True,
                              window=cfg.sliding_window)
    return _out(out, p["wo"]), (k, v)


def init_gqa_cache(cfg, b: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda", *, lead=()):
    """KV cache; SWA archs use a ring buffer of size window.  ``lead``
    prepends stacked-layer dimensions."""
    t = min(cfg.sliding_window, seq_len) if cfg.sliding_window else seq_len
    kw = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((*lead, b, t, cfg.kv_heads, cfg.hd), **kw),
        "v": torch.zeros((*lead, b, t, cfg.kv_heads, cfg.hd), **kw),
        "pos": torch.full((*lead, b, t), -1, dtype=torch.int32,
                          device=device),
    }


def apply_gqa_decode(cfg, p, x, position, cache):
    """One-token decode against a KV cache, which is written in place.

    x: (B, 1, d); position: (B,) absolute position of the new token.
    cache['pos'] stores the absolute position held in each slot (-1 empty).
    """
    b = x.shape[0]
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos = position[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = (position % ck.shape[1]).long()
    bidx = torch.arange(b, device=x.device)
    ck[bidx, slot] = k[:, 0].to(ck.dtype)
    cv[bidx, slot] = v[:, 0].to(cv.dtype)
    cpos[bidx, slot] = position.to(cpos.dtype)

    hkv, hd = ck.shape[2], ck.shape[3]
    h = q.shape[2]
    qf = (q[:, 0] * cfg.hd ** -0.5).float().view(b, hkv, h // hkv, hd)
    sco = torch.einsum("bgrk,btgk->bgrt", qf, ck.float()).reshape(b, h, -1)
    ok = (cpos >= 0) & (cpos <= position[:, None])
    if cfg.sliding_window:
        ok &= cpos > (position[:, None] - cfg.sliding_window)
    sco = torch.where(ok[:, None, :], sco, NEG_INF)
    prob = torch.softmax(sco, dim=-1).view(b, hkv, h // hkv, -1)
    out = torch.einsum("bgrt,btgk->bgrk", prob, cv.float()).reshape(b, h, hd)
    y = _out(out.to(x.dtype), p["wo"])[:, None, :]
    return y, cache
