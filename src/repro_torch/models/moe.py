"""Mixture-of-Experts layer: top-k routing with static-capacity dispatch
(port of ``repro.models.moe``).

Dispatch is the reference's dense one, reproduced exactly: each (token,
choice) pair takes the slot its expert's running count gives it in the
flattened (T*k) order (a one-hot cumulative sum), pairs past an expert's
capacity ``max(int(T*k/E*cf), 4)`` are dropped, the kept tokens are
gathered into (E, C, d) buffers, the experts run as batched matrix products
(``torch.bmm``: the reference leaves these to XLA, outside any Pallas
kernel), and the combine sums each token's weighted kept outputs; shared
experts are added after it.

Routers: 'softmax' (with the reference's load-balance auxiliary loss) and
'sigmoid' (DeepSeek-V3 aux-loss-free: sigmoid affinities, top-k, weights
normalised over the selected experts).

The expert-parallel path (``apply_moe_ep``, shard_map with two
all_to_alls) needs a device mesh; the reference takes it only under one,
so a single card always takes the dense dispatch, in serving and in
training (the router's aux loss is differentiated through it).  The
expert-parallel path is ROADMAP items 15.6c and 15.7, with
``parallel/sharding.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import normal

EP_ITEM = "ROADMAP §1 items 15.6c and 15.7 (with parallel/sharding.py)"


def init_moe(cfg, generator, dtype, device, *, lead=()):
    """``lead`` prepends stacked-layer dimensions.  The router stays f32
    under any dtype, as in the reference."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    s_in, s_out = (2.0 / d) ** 0.5, (2.0 / f) ** 0.5
    e = m.n_experts

    def w(shape, scale, dt=dtype):
        return normal(generator, (*lead, *shape), scale, dt, device)
    p = {
        "router": w((d, e), 0.02, torch.float32),
        "wi": w((e, d, f), s_in),
        "wo": w((e, f, d), s_out),
    }
    if cfg.act == "swiglu":
        p["wg"] = w((e, d, f), s_in)
    if m.n_shared:
        fs = f * m.n_shared
        p["sh_wi"] = w((d, fs), s_in)
        p["sh_wo"] = w((fs, d), s_out)
        if cfg.act == "swiglu":
            p["sh_wg"] = w((d, fs), s_in)
    return p


def _route(cfg, p, x2):
    """x2: (T, d) -> (weights (T,k) f32, experts (T,k), aux_loss)."""
    m = cfg.moe
    logits = x2.float() @ p["router"]                      # (T, E)
    if m.router == "sigmoid":
        w, idx = torch.topk(torch.sigmoid(logits), m.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        aux = torch.zeros((), device=x2.device)            # aux-free
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, m.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        # Switch-style load-balance loss, the reference's formula
        me = probs.mean(0)
        ce = torch.mean(F.one_hot(idx[:, 0], m.n_experts).float().sum(0)
                        / x2.shape[0])
        aux = m.n_experts * torch.sum(me * ce)
    return w, idx, aux


def _experts(cfg, p, buf):
    """The experts on their (E, C, d) buffers."""
    if cfg.act == "swiglu":
        h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    else:
        h = F.gelu(torch.bmm(buf, p["wi"]), approximate="tanh")
    return torch.bmm(h, p["wo"])


def dispatch(cfg, idx, t: int):
    """Slots of the flattened (T*k) (token, choice) pairs: (expert ids,
    slots within their experts, kept mask, capacity)."""
    m = cfg.moe
    e = m.n_experts
    cap = max(int(t * m.top_k / e * m.capacity_factor), 4)
    eid = idx.reshape(-1)                                  # (T*k,)
    n = eid.shape[0]
    # position of each pair within its expert: the running count before it,
    # scanned along the contiguous pair axis of an (E, T*k) one-hot (torch's
    # scan along the outer axis of the (T*k, E) one took 72 % of moonshot's
    # prefill on the card: PERF.md §5)
    onehot = torch.zeros((e, n), dtype=torch.int32, device=idx.device)
    onehot.scatter_(0, eid[None], 1)
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    slot = count.gather(0, eid[None])[0] - 1
    return eid, slot, slot < cap, cap


def apply_moe_dense(cfg, p, x):
    """x: (B, S, d) -> (y, aux_loss): the reference's dense dispatch."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    w, idx, aux = _route(cfg, p, x2)
    eid, slot, keep, cap = dispatch(cfg, idx, t)
    e = m.n_experts

    # the token each (expert, slot) holds; empty slots read a zero row
    flat = torch.where(keep, eid * cap + slot, e * cap)    # drops: a spare
    src = torch.full((e * cap + 1,), t, dtype=torch.long, device=x.device)
    tok = torch.arange(t, device=x.device).repeat_interleave(m.top_k)
    src.scatter_(0, flat, tok)
    rows = torch.cat([x2, x2.new_zeros((1, d))])
    buf = rows[src[:-1]].view(e, cap, d)

    out = _experts(cfg, p, buf).view(e * cap, d)

    # combine: each kept (token, choice) output, weighted, summed per token
    got = out[torch.clamp(flat, max=e * cap - 1)]
    got = torch.where(keep[:, None], got, 0)
    y = (got * w.reshape(-1, 1).to(x.dtype)).view(t, m.top_k, d).sum(1)

    if m.n_shared:
        if cfg.act == "swiglu":
            hs = F.silu(x2 @ p["sh_wg"]) * (x2 @ p["sh_wi"])
        else:
            hs = F.gelu(x2 @ p["sh_wi"], approximate="tanh")
        y = y + hs @ p["sh_wo"]
    return y.view(b, s, d), aux


def apply_moe(cfg, p, x):
    """x: (B, S, d) -> (y, aux_loss).  'auto' and 'dense' take the dense
    dispatch (one card has no mesh); the expert-parallel path raises."""
    impl = getattr(cfg, "moe_impl", "auto")
    if impl not in ("auto", "dense"):
        raise NotImplementedError(
            f"moe_impl {impl!r}: the expert-parallel dispatch is {EP_ITEM}")
    return apply_moe_dense(cfg, p, x)
