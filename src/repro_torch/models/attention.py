"""Attention variants: GQA (+QKV bias, sliding window) and MLA (DeepSeek)
(port of ``repro.models.attention``).

Prefill and training run the hand-written flash-attention kernels
(:func:`repro_torch.kernels.attention.kernel.flash_attention`: the forward
kernel alone when nothing needs a gradient, else the autograd Function
with the backward kernel) where the reference calls
``chunked_attention``; at positions 0..S-1 with no KV mask
the two compute the same function, and ``chunked_attention`` is kept as a
plain function that the tests hold the kernel path against.  MLA's prefill
expands the latent and runs the same kernel at d = qk_nope + qk_rope (192
for deepseek-v3) and dv = v_head (128).  Decode attends one query against
a cache that is updated in place (MLA's holds the compressed latent and
scores in it through the absorbed matmuls, in plain torch as in the
reference).  Head dimensions are padded up to a multiple of the
tensor-parallel degree as in the reference, so parameter shapes match it;
q head i reads kv head i // (H / Hkv), the reference's ``jnp.repeat``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.models.common import apply_rope, normal, rmsnorm
from repro_torch.parallel.sharding import (heads_local_map, is_dtensor,
                                           redistribute)

NEG_INF = -1e30


def pad_heads(h: int, tp: int) -> int:
    return -(-h // tp) * tp


def init_gqa(cfg, generator, tp: int, dtype, device, *, lead=()):
    """``lead`` prepends stacked-layer dimensions."""
    d, hd = cfg.d_model, cfg.hd
    hp = pad_heads(cfg.n_heads, tp)
    # kv heads below the TP degree stay logical; above it they are padded
    kvp = cfg.kv_heads if cfg.kv_heads <= tp else pad_heads(cfg.kv_heads, tp)
    s = (1.0 / d) ** 0.5
    p = {
        "wq": normal(generator, (*lead, d, hp, hd), s, dtype, device),
        "wk": normal(generator, (*lead, d, kvp, hd), s, dtype, device),
        "wv": normal(generator, (*lead, d, kvp, hd), s, dtype, device),
        "wo": normal(generator, (*lead, hp, hd, d), s, dtype, device),
    }
    if cfg.qkv_bias:
        kw = dict(dtype=dtype, device=device)
        p["bq"] = torch.zeros((*lead, hp, hd), **kw)
        p["bk"] = torch.zeros((*lead, kvp, hd), **kw)
        p["bv"] = torch.zeros((*lead, kvp, hd), **kw)
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


def attend(q, k, v, *, causal=True, window=0, fa=None):
    """``fa`` (:func:`flash_attention` by default) as the models call it;
    on DTensors (a mesh) it runs on each rank's own heads through
    ``local_map``, the kv heads of a rank's q heads handed to it whole."""
    fa = fa or flash_attention
    if not is_dtensor(q):
        return fa(q, k, v, causal=causal, window=window)
    return heads_local_map(
        lambda ql, kl, vl: fa(ql, kl, vl, causal=causal, window=window),
        (q, k, v), (("h", 2, True), ("g", 2, True), ("g", 2, True)))


def apply_gqa(cfg, p, x, positions):
    """Prefill self-attention through the flash kernel.  ``positions`` must
    be 0..S-1 in every row (the kernel's causal and window masks use row
    indices).  Returns (out, (k, v))."""
    q, k, v = _qkv(cfg, p, x, positions)
    out = attend(q, k, v, causal=True, window=cfg.sliding_window)
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


def write_slots(buf, slot, value) -> None:
    """``buf[b, slot[b]] = value[b]`` for every row b, in place (a cache
    (B, T, ...) and the new token's (B, ...)).  On DTensors each rank
    writes its own rows (and heads) into its own shard: ``value`` and
    ``slot`` are first placed to match ``buf`` (its T must not be
    split)."""
    if is_dtensor(buf):
        from torch.distributed.tensor import Replicate, Shard
        if any(isinstance(p, Shard) and p.dim == 1 for p in buf.placements):
            raise ValueError("a cache split over its slots takes no write")
        want_v = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                  else p for p in buf.placements]
        want_s = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in buf.placements]
        value = redistribute(value, want_v).to_local()
        slot = redistribute(slot, want_s).to_local()
        buf = buf.to_local()
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, slot] = value.to(buf.dtype)


def _decode_attend(cfg, q, ck, cv, cpos, position, reduce=None):
    """One query (B, 1, H, hd) against the cache: (B, 1, H, hd) in f32.
    ``reduce`` (on the raw scores) sums them over a split head
    dimension."""
    b, hkv, hd = q.shape[0], ck.shape[2], ck.shape[3]
    h = q.shape[2]
    qf = (q[:, 0] * cfg.hd ** -0.5).float().view(b, hkv, h // hkv, hd)
    sco = torch.einsum("bgrk,btgk->bgrt", qf, ck.float())
    if reduce is not None:
        sco = reduce(sco)
    sco = sco.reshape(b, h, -1)
    ok = (cpos >= 0) & (cpos <= position[:, None])
    if cfg.sliding_window:
        ok &= cpos > (position[:, None] - cfg.sliding_window)
    sco = torch.where(ok[:, None, :], sco, NEG_INF)
    prob = torch.softmax(sco, dim=-1).view(b, hkv, h // hkv, -1)
    return torch.einsum("bgrt,btgk->bgrk", prob, cv.float()).reshape(
        b, 1, h, hd)


def _decode_attend_mesh(cfg, q, ck, cv, cpos, position):
    """:func:`_decode_attend` on DTensors.  A cache split by kv heads (or
    whole) runs on each rank's q heads (``heads_local_map``).  A cache
    whose head dimension is split (the dry run's cache rule where the kv
    heads do not divide "model") keeps it: q is moved to the same split,
    each rank scores its slice of every head and one all-reduce a split
    mesh dimension sums the slices, so no rank gathers the cache.
    (B, 1, H, hd), placed like q (or, split, like the cache)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    split = [i for i, pl in enumerate(ck.placements)
             if isinstance(pl, Shard) and pl.dim == 3]
    if not split:
        return heads_local_map(
            lambda ql, kl, vl, pl, pos: _decode_attend(cfg, ql, kl, vl, pl,
                                                       pos),
            (q, ck, cv, cpos, position),
            (("h", 2, True), ("g", 2, True), ("g", 2, True),
             ("b", None, True), ("b", None, True)))
    mesh = ck.device_mesh
    row = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
           for pl in ck.placements]
    q_pl = [Shard(3) if i in split else pl for i, pl in enumerate(row)]

    def reduce(sco):
        for i in split:
            sco = funcol.all_reduce(sco, "sum", (mesh, i))
        return sco

    def body(ql, kl, vl, pl, pos):
        return _decode_attend(cfg, ql, kl, vl, pl, pos, reduce)

    return local_map(body, out_placements=q_pl,
                     in_placements=(q_pl, list(ck.placements),
                                    list(cv.placements), row, row),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, ck, cv, cpos, position)


def apply_gqa_decode(cfg, p, x, position, cache):
    """One-token decode against a KV cache, which is written in place.

    x: (B, 1, d); position: (B,) absolute position of the new token.
    cache['pos'] stores the absolute position held in each slot (-1 empty).
    On DTensors each rank writes and attends with its own shard
    (:func:`write_slots`, :func:`_decode_attend_mesh`).
    """
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    pos = position[:, None]
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = (position % ck.shape[1]).long()
    write_slots(ck, slot, k[:, 0])
    write_slots(cv, slot, v[:, 0])
    write_slots(cpos, slot, position)
    if is_dtensor(q):
        out = _decode_attend_mesh(cfg, q, ck, cv, cpos, position)
    else:
        out = _decode_attend(cfg, q, ck, cv, cpos, position)
    y = _out(out[:, 0].to(x.dtype), p["wo"])[:, None, :]
    return y, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(cfg, generator, dtype, device, *, lead=()):
    """``lead`` prepends stacked-layer dimensions."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    s = (1.0 / d) ** 0.5

    def w(shape, scale):
        return normal(generator, (*lead, *shape), scale, dtype, device)

    def ones(n):
        return torch.ones((*lead, n), dtype=dtype, device=device)
    return {
        "wq_a": w((d, m.q_lora), s),
        "q_norm": ones(m.q_lora),
        "wq_b": w((m.q_lora, h, m.qk_nope + m.qk_rope),
                  (1.0 / m.q_lora) ** 0.5),
        "wkv_a": w((d, m.kv_lora + m.qk_rope), s),
        "kv_norm": ones(m.kv_lora),
        "wk_b": w((m.kv_lora, h, m.qk_nope), (1.0 / m.kv_lora) ** 0.5),
        "wv_b": w((m.kv_lora, h, m.v_head), (1.0 / m.kv_lora) ** 0.5),
        "wo": w((h, m.v_head, d), (1.0 / (h * m.v_head)) ** 0.5),
    }


def apply_mla(cfg, p, x, positions):
    """Prefill MLA: expand the latent, then the flash kernel, causal, at
    d = qk_nope + qk_rope and dv = v_head (the scale is that d's).
    ``positions`` must be 0..S-1 in every row.  Returns (out, (ckv, k_rope))."""
    m = cfg.mla
    cq = rmsnorm(x @ p["wq_a"], p["q_norm"])
    q = _proj(cq, p["wq_b"])
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ p["wkv_a"]
    ckv = rmsnorm(kv[..., :m.kv_lora], p["kv_norm"])
    k_rope = apply_rope(kv[..., None, m.kv_lora:], positions,
                        cfg.rope_theta)                     # (B,S,1,rope)
    k_nope = _proj(ckv, p["wk_b"])
    v = _proj(ckv, p["wv_b"])

    qc = torch.cat([q_nope, q_rope], dim=-1)
    kc = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1], m.qk_rope)],
                   dim=-1)
    out = attend(qc, kc, v, causal=True)
    return _out(out, p["wo"]), (ckv, k_rope)


def init_mla_cache(cfg, b: int, seq_len: int, dtype=torch.bfloat16,
                   device="cuda", *, lead=()):
    """Compressed-latent cache: (kv_lora + qk_rope) per token.  ``lead``
    prepends stacked-layer dimensions."""
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    return {
        "ckv": torch.zeros((*lead, b, seq_len, m.kv_lora), **kw),
        "kr": torch.zeros((*lead, b, seq_len, m.qk_rope), **kw),
        "pos": torch.full((*lead, b, seq_len), -1, dtype=torch.int32,
                          device=device),
    }


def apply_mla_decode(cfg, p, x, position, cache):
    """Absorbed-matmul MLA decode against the latent cache, which is
    written in place: scores and values in the latent space (W_uk folded
    into q, W_uv into the output projection)."""
    m = cfg.mla
    cq = rmsnorm(x @ p["wq_a"], p["q_norm"])
    q = _proj(cq, p["wq_b"])[:, 0]                       # (B,H,nope+rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    pos = position[:, None]
    q_rope = apply_rope(q_rope[:, None], pos, cfg.rope_theta)[:, 0]

    kv = (x @ p["wkv_a"])[:, 0]
    ckv_new = rmsnorm(kv[..., :m.kv_lora], p["kv_norm"])
    kr_new = apply_rope(kv[:, None, None, m.kv_lora:], pos,
                        cfg.rope_theta)[:, 0, 0]

    ckv, kr, cpos = cache["ckv"], cache["kr"], cache["pos"]
    slot = (position % ckv.shape[1]).long()
    write_slots(ckv, slot, ckv_new)
    write_slots(kr, slot, kr_new)
    write_slots(cpos, slot, position)

    # absorb: q_eff[h] = q_nope[h] @ wk_b[:, h, :]^T (latent-space query)
    q_eff = torch.einsum("bhk,lhk->bhl", q_nope, p["wk_b"])
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    ckv32 = ckv.float()
    sco = (torch.einsum("bhl,btl->bht", q_eff.float(), ckv32)
           + torch.einsum("bhk,btk->bht", q_rope.float(), kr.float())) * scale
    ok = (cpos >= 0) & (cpos <= position[:, None])
    sco = torch.where(ok[:, None, :], sco, NEG_INF)
    prob = torch.softmax(sco, dim=-1)
    out_l = torch.einsum("bht,btl->bhl", prob, ckv32)
    out = torch.einsum("bhl,lhk->bhk", out_l.to(x.dtype), p["wv_b"])
    y = _out(out, p["wo"])[:, None, :]
    return y, cache
