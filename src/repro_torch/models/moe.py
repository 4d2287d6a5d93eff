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

Under a mesh (``parallel/sharding.py``: DTensor parameters and batch) the
layer takes the reference's expert-parallel path, :func:`apply_moe_ep`,
when the mesh has a "model" dimension and the tokens divide the whole
mesh, or always with ``moe_impl="ep"``: inside ``local_map`` (the
reference's ``shard_map``) each model-rank routes its slice of its
data-parallel shard's tokens, scatters them into per-destination send
buffers, exchanges them with one ``all_to_all_single`` over the expert
group and back with another, runs its local experts as ``torch.bmm`` and
combines locally; the shared experts run on the same slice and an
all-gather over "model" reassembles the shard.  Its capacity is per
model-rank (``max(int(t_me*k/E*cf), 1)``), the dense dispatch's global,
so the two drop different tokens unless nothing drops.  The dense
dispatch under a mesh (``moe_impl="dense"``, or a mesh the reference
would not take) runs on gathered, replicated tokens and weights.  With
no mesh ``"auto"``, ``"dense"`` and ``"ep"`` all take the dense dispatch,
as in the reference.  While ``DROPS`` is a list, each dispatch appends
the (token, choice) pairs it dropped (a host sync).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.common import normal
from repro_torch.parallel import sharding as sh

IMPLS = ("auto", "dense", "ep")
DROPS = None        # a list: dropped (token, choice) pairs per dispatch


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


def _slots(eid, e: int):
    """Each pair's position within its expert: the running count before
    it, scanned along the contiguous pair axis of an (E, n) one-hot
    (torch's scan along the outer axis of the (n, E) one took 72 % of
    moonshot's prefill on the card: PERF.md §5)."""
    n = eid.shape[0]
    onehot = torch.zeros((e, n), dtype=torch.int32, device=eid.device)
    onehot.scatter_(0, eid[None], 1)
    count = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    return count.gather(0, eid[None])[0] - 1


def _note_drops(keep) -> None:
    if DROPS is not None:
        DROPS.append(int((~keep).sum()))


def dispatch(cfg, idx, t: int):
    """Slots of the flattened (T*k) (token, choice) pairs: (expert ids,
    slots within their experts, kept mask, capacity)."""
    m = cfg.moe
    e = m.n_experts
    cap = max(int(t * m.top_k / e * m.capacity_factor), 4)
    eid = idx.reshape(-1)                                  # (T*k,)
    slot = _slots(eid, e)
    _note_drops(slot < cap)
    return eid, slot, slot < cap, cap


def _gather_rows(x2, flat, n_slots: int, top_k: int):
    """(n_slots, d): the token each slot holds (``flat`` the slot of each
    (token, choice) pair, ``n_slots`` for a dropped one); empty slots
    read a zero row."""
    t, d = x2.shape
    src = torch.full((n_slots + 1,), t, dtype=torch.long, device=x2.device)
    tok = torch.arange(t, device=x2.device).repeat_interleave(top_k)
    src.scatter_(0, flat, tok)
    rows = torch.cat([x2, x2.new_zeros((1, d))])
    return rows[src[:-1]]


def _combine(out, flat, keep, w, top_k: int, dtype):
    """Each kept (token, choice) output of ``out`` (n_slots, d), weighted,
    summed per token."""
    got = out[torch.clamp(flat, max=out.shape[0] - 1)]
    got = torch.where(keep[:, None], got, 0)
    return (got * w.reshape(-1, 1).to(dtype)).view(
        -1, top_k, out.shape[1]).sum(1)


def _shared(cfg, p, x2):
    if cfg.act == "swiglu":
        hs = F.silu(x2 @ p["sh_wg"]) * (x2 @ p["sh_wi"])
    else:
        hs = F.gelu(x2 @ p["sh_wi"], approximate="tanh")
    return hs @ p["sh_wo"]


def apply_moe_dense(cfg, p, x):
    """x: (B, S, d) -> (y, aux_loss): the reference's dense dispatch."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    w, idx, aux = _route(cfg, p, x2)
    eid, slot, keep, cap = dispatch(cfg, idx, t)
    e = m.n_experts

    flat = torch.where(keep, eid * cap + slot, e * cap)    # drops: a spare
    buf = _gather_rows(x2, flat, e * cap, m.top_k).view(e, cap, d)
    out = _experts(cfg, p, buf).view(e * cap, d)
    y = _combine(out, flat, keep, w, m.top_k, x.dtype)
    if m.n_shared:
        y = y + _shared(cfg, p, x2)
    return y.view(b, s, d), aux


def apply_moe(cfg, p, x):
    """x: (B, S, d) -> (y, aux_loss).  With no mesh: the dense dispatch.
    Under a mesh: the expert-parallel path where the reference takes it
    (a "model" dimension, tokens dividing the whole mesh) or with
    ``moe_impl="ep"``, else the dense dispatch on replicated tensors."""
    impl = getattr(cfg, "moe_impl", "auto")
    if impl not in IMPLS:
        raise ValueError(f"moe_impl {impl!r}: one of {IMPLS}")
    mesh = sh.current_mesh() if sh.is_dtensor(x) else None
    if mesh is None:
        return apply_moe_dense(cfg, p, x)
    if impl != "dense":
        sizes = sh.mesh_dims(mesh)
        t, n_all = x.shape[0] * x.shape[1], math.prod(sizes.values())
        if impl == "ep" or ("model" in sizes and t % n_all == 0
                            and t >= n_all):
            return apply_moe_ep(cfg, p, x, mesh, strict=impl == "ep")
    return _dense_on_mesh(cfg, p, x)


def _replicated_map(fn, args, n_out: int):
    """``fn`` on whole (gathered) local copies of DTensor ``args``; every
    rank computes the same outputs, returned replicated."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    return local_map(fn, out_placements=(rep,) * n_out,
                     in_placements=(rep,) * len(args), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _dense_on_mesh(cfg, p, x):
    """The dense dispatch under a mesh: its data-dependent scatter has no
    sharding rule, so it runs on gathered tokens and weights (the
    reference's GSPMD fallback replicates the expert buffers too)."""
    keys = sorted(p)
    y, aux = _replicated_map(
        lambda xl, *ws: apply_moe_dense(cfg, dict(zip(keys, ws)), xl),
        (x, *(p[k] for k in keys)), 2)
    return sh.shard(y, "batch", "seq_act", "embed"), aux


# ---------------------------------------------------------------------------
# Expert-parallel path: local_map + all_to_all (the DeepSeek EP pattern)
# ---------------------------------------------------------------------------

def _ep_axes(mesh, n_experts):
    """The mesh dimensions the experts split over: (data, model) when the
    expert count covers both, else model; (None, 1) when neither
    divides."""
    sizes = sh.mesh_dims(mesh)
    for axes in (("data", "model"), ("model",)):
        if all(a in sizes for a in axes):
            n = math.prod(sizes[a] for a in axes)
            if n_experts % n == 0 and n_experts >= n:
                return axes, n
    return None, 1


_GROUPS = {}


def _expert_group(mesh, axes):
    """The process group over mesh dimensions ``axes`` that holds this
    rank (flattened in mesh order: rank j of it holds expert block j).
    Built once per mesh, by every rank."""
    key = (id(mesh), axes)
    if key not in _GROUPS:
        sub = mesh[axes[0]] if len(axes) == 1 else \
            mesh[axes]._flatten("_".join(axes))
        _GROUPS[key] = sub.get_group()
    return _GROUPS[key]


def _a2a(x, group):
    """``all_to_all_single`` of equal blocks along dim 0 (gloo takes CUDA
    tensors here, copying them through the host itself)."""
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The token exchange; its gradient is the same exchange back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def apply_moe_ep(cfg, p, x, mesh, *, strict: bool = False):
    """The expert-parallel MoE layer on DTensor ``x`` (B, S, d) ->
    (y, aux).  Tokens enter split over the data-parallel dimensions and
    whole over "model"; each model-rank takes its slice inside the body
    and the all-gather over "model" on the way out reassembles the
    shard.  Where the experts or tokens do not divide, the reference
    takes the dense dispatch; ``strict`` (``moe_impl="ep"``) raises."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    sizes = sh.mesh_dims(mesh)
    names = list(mesh.mesh_dim_names)
    exp_axes, n_exp = _ep_axes(mesh, m.n_experts)
    dp = [a for a in ("pod", "data") if a in sizes]
    n_dp = math.prod(sizes[a] for a in dp)
    n_tp = sizes.get("model", 1)
    if exp_axes is None or t % (n_dp * n_tp):
        if strict:
            raise ValueError(
                f"moe_impl='ep' on mesh {sizes}: needs a 'model' dimension "
                f"that (with 'data') divides {m.n_experts} experts, and "
                f"{t} tokens dividing {n_dp * n_tp} ranks")
        return _dense_on_mesh(cfg, p, x)
    t_dp = t // n_dp                    # tokens per dp shard
    t_me = t_dp // n_tp                 # tokens this model-rank works on
    e_loc = m.n_experts // n_exp
    cap = max(int(t_me * m.top_k / m.n_experts * m.capacity_factor), 1)
    n_all = math.prod(sizes.values())
    mi = sh.mesh_coord(mesh, names.index("model")) if "model" in sizes \
        else 0
    group = _expert_group(mesh, exp_axes)
    slots = n_exp * e_loc * cap

    def body(x_loc, router, wi, wg, wo, *shw):
        x_me = x_loc[mi * t_me:(mi + 1) * t_me]
        # the reference's _route_local: _route on this rank's tokens
        w, idx, aux = _route(cfg, {"router": router}, x_me)
        eid = idx.reshape(-1)                              # (t_me*k,)
        dev, sub = eid // e_loc, eid % e_loc
        slot = _slots(eid, m.n_experts)                    # per expert
        keep = slot < cap
        _note_drops(keep)
        # local scatter into per-destination send buffers
        flat = torch.where(keep, dev * (e_loc * cap) + sub * cap + slot,
                           slots)
        send = _gather_rows(x_me, flat, slots, m.top_k)
        # token exchange: one all_to_all there...
        recv = _AllToAll.apply(send, group)
        # recv block j = tokens from device j for MY experts
        toks = recv.view(n_exp, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, n_exp * cap, d)
        out = _experts(cfg, {"wi": wi, "wg": wg, "wo": wo}, toks)
        # ... and one back
        back = out.view(e_loc, n_exp, cap, d).transpose(0, 1).reshape(
            slots, d)
        got = _AllToAll.apply(back, group)
        y_me = _combine(got, flat, keep, w, m.top_k, x_loc.dtype)
        if m.n_shared:
            y_me = y_me + _shared(cfg, dict(zip(sh_keys, shw)), x_me)
        return y_me, aux / n_all

    sh_keys = sorted(k for k in p if k.startswith("sh_"))
    rep = [Replicate()] * len(names)
    part = [Partial()] * len(names)
    x_pl = [Shard(0) if a in dp else Replicate() for a in names]
    x_grad = [Partial() if a == "model" else pl
              for a, pl in zip(names, x_pl)]
    e_pl = [Shard(0) if a in exp_axes else Replicate() for a in names]
    e_grad = [Shard(0) if a in exp_axes else Partial() for a in names]
    y_pl = [Shard(0) if a in dp or a == "model" else Replicate()
            for a in names]
    wg = p.get("wg", p["wi"])
    n_sh = len(sh_keys)
    y, aux = local_map(
        body, out_placements=(y_pl, part),
        in_placements=(x_pl, rep, e_pl, e_pl, e_pl) + (rep,) * n_sh,
        in_grad_placements=(x_grad, part, e_grad, e_grad, e_grad)
        + (part,) * n_sh,
        device_mesh=mesh, redistribute_inputs=True,
    )(x.reshape(t, d), p["router"], p["wi"], wg, p["wo"],
      *(p[k] for k in sh_keys))
    # reassemble the dp shard from the model-rank slices
    y = sh.redistribute(y, x_pl)
    return y.view(b, s, d), aux
