"""Decoder-only LM covering the dense / moe / vlm / ssm / hybrid families
(port of ``repro.models.transformer``).

Layers of a group are stacked along a leading dimension as in the reference
(a heterogeneous stack, e.g. deepseek's 3 leading dense layers, is a list
of homogeneous groups); where it runs ``lax.scan`` over them the port loops
over the layer index.  Attention layers are GQA (``models/attention.py``,
with QKV bias and the sliding-window ring buffer) or MLA; the feed-forward
is an MLP or an MoE (``models/moe.py``).  Every attention of the forward
runs the flash kernels (forward, and backward in training).  ``forward``
returns the MoE auxiliary loss as the reference does; ``remat=True`` wraps
each layer in ``torch.utils.checkpoint`` (non-reentrant), as the
reference's ``_remat_wrap`` wraps each scanned layer, and
``remat="save_collectives"`` does so under a selective-checkpoint policy
that keeps each block's two outputs (the reference's ``blk_out``) and,
under a mesh, the outputs of the block's collectives, so the backward
reuses the tensor-parallel all-reduces instead of re-issuing them.  On a
mesh the parameters and the batch are DTensors and the reference's
``shard`` constraints redistribute the residual stream
(``parallel/sharding.py``); with no mesh they do nothing.  Decode updates
its caches in place and returns the same dictionary.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models.common import (apply_mlp, apply_norm, chunked_xent,
                                       init_mlp, init_norm, normal)
from repro_torch.models.config import ArchConfig
from repro_torch.parallel.sharding import (embedding_lookup, is_dtensor,
                                           shard)
from repro_torch.utils.device import resolve_device

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str          # 'dense' | 'moe' | 'ssm'
    count: int
    d_ff: int = 0
    shared_attn: bool = False   # hybrid: shared attn+mlp every shared_every


def layer_groups(cfg: ArchConfig) -> list[LayerGroup]:
    if cfg.family == "ssm":
        return [LayerGroup("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        return [LayerGroup("ssm", cfg.n_layers, shared_attn=True)]
    if cfg.moe is not None:
        groups = []
        if cfg.moe.first_dense:
            groups.append(LayerGroup("dense", cfg.moe.first_dense,
                                     d_ff=cfg.moe.d_ff_dense or cfg.d_ff))
        groups.append(LayerGroup("moe", cfg.n_layers - cfg.moe.first_dense))
        return groups
    return [LayerGroup("dense", cfg.n_layers, d_ff=cfg.d_ff)]


def _stack(tree, n: int):
    """``tree`` with every leaf repeated along a new leading dim of n."""
    return {k: _stack(v, n) if isinstance(v, dict) else
            v.expand(n, *v.shape).clone() for k, v in tree.items()}


def index_layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    return {k: index_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack_layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree, one ``unbind`` per leaf (views):
    in training each leaf's gradient is then stacked once from its layers'
    gradients, where a slice per layer would add a full-size zero
    gradient per layer."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = (unstack_layers(v, n) if isinstance(v, dict) else
                 torch.unbind(v))
        for i in range(n):
            out[i][k] = parts[i]
    return out


REMAT_POLICIES = (False, None, True, "save_collectives")
# the op that marks a block output for "save_collectives" (the reference's
# checkpoint_name(x, "blk_out")); nothing else in the models calls it
BLK_OUT = torch.ops.aten.alias_copy.default


def check_remat(remat) -> None:
    """``remat`` is False/None, True, or the reference's
    ``"save_collectives"`` policy."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat={remat!r}: one of {REMAT_POLICIES}")


def blk_out(x, save: bool):
    """``x`` marked as a block output that ``"save_collectives"`` keeps
    (a copy, made only under that policy)."""
    return BLK_OUT(x) if save else x


def _save_collectives(ctx, op, *args, **kwargs):
    """Keep the marked block outputs and every functional collective's
    output (the tensor-parallel all-reduces and gathers: the backward's
    recomputation then re-issues none); recompute the rest."""
    if op is BLK_OUT or getattr(op, "namespace", "") == "_c10d_functional":
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant: its
    activations are recomputed in the backward) when ``remat``; under the
    ``"save_collectives"`` policy's selective checkpoint for that one."""
    if remat == "save_collectives":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (
                              create_selective_checkpoint_contexts(
                                  _save_collectives)))
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layers(cfg: ArchConfig, grp: LayerGroup, generator, tp: int,
                 dtype, device) -> dict:
    """One group's stacked layers (leading dimension ``grp.count``)."""
    d, n = cfg.d_model, grp.count
    if grp.kind == "ssm":
        return {"norm_ssm": _stack(init_norm(cfg, d, dtype, device), n),
                "ssm": ssm_mod.init_mamba2(cfg, generator, dtype, device,
                                           lead=(n,))}
    p = {"norm_attn": _stack(init_norm(cfg, d, dtype, device), n)}
    if cfg.mla is not None:
        p["attn"] = attn.init_mla(cfg, generator, dtype, device, lead=(n,))
    else:
        p["attn"] = attn.init_gqa(cfg, generator, tp, dtype, device,
                                  lead=(n,))
    p["norm_mlp"] = _stack(init_norm(cfg, d, dtype, device), n)
    if grp.kind == "moe":
        p["moe"] = moe_mod.init_moe(cfg, generator, dtype, device,
                                    lead=(n,))
    else:
        p["mlp"] = init_mlp(cfg, generator, d, grp.d_ff or cfg.d_ff, dtype,
                            device, lead=(n,))
    return p


def init_lm(cfg: ArchConfig, generator, tp: int, dtype, device) -> dict:
    vp = padded_vocab(cfg.vocab)
    d = cfg.d_model
    params = {
        "embed": normal(generator, (vp, d), d ** -0.5, dtype, device),
        "final_norm": init_norm(cfg, d, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (d, vp), d ** -0.5, dtype,
                                   device)
    for gi, grp in enumerate(layer_groups(cfg)):
        params[f"g{gi}"] = _init_layers(cfg, grp, generator, tp, dtype,
                                        device)
    if cfg.family == "hybrid":
        params["shared"] = {
            "norm_attn": init_norm(cfg, d, dtype, device),
            "attn": attn.init_gqa(cfg, generator, tp, dtype, device),
            "norm_mlp": init_norm(cfg, d, dtype, device),
            "mlp": init_mlp(cfg, generator, d, cfg.d_ff, dtype, device),
        }
    return params


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _apply_block(cfg, kind, p, h, positions, save=False):
    """One layer: (h, aux), aux the MoE router's loss (0 elsewhere).
    ``save`` marks the attention and MLP / MoE outputs for the
    ``"save_collectives"`` policy (under a mesh, after their
    all-reduce)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind == "ssm":
        hn = apply_norm(cfg, p["norm_ssm"], h)
        return h + ssm_mod.apply_mamba2(cfg, p["ssm"], hn), aux
    hn = apply_norm(cfg, p["norm_attn"], h)
    if cfg.mla is not None:
        a, _ = attn.apply_mla(cfg, p["attn"], hn, positions)
    else:
        a, _ = attn.apply_gqa(cfg, p["attn"], hn, positions)
    h = h + blk_out(shard(a, "batch", "seq_act", "embed"), save)
    hn = apply_norm(cfg, p["norm_mlp"], h)
    if kind == "moe":
        y, aux = moe_mod.apply_moe(cfg, p["moe"], hn)
    else:
        y = apply_mlp(cfg, p["mlp"], hn)
    h = h + blk_out(shard(y, "batch", "seq_act", "embed"), save)
    return shard(h, "batch", "seq_act", "embed"), aux


def _shared_block(cfg, p, h, resid, positions):
    """Zamba2 shared attention+MLP block (weight-tied across invocations).
    Input is h + the token-embedding residual (the reference's additive
    approximation of zamba2's concat-reproject)."""
    x = h + resid
    hn = apply_norm(cfg, p["norm_attn"], x)
    a, _ = attn.apply_gqa(cfg, p["attn"], hn, positions)
    x = x + a
    hn = apply_norm(cfg, p["norm_mlp"], x)
    return x + apply_mlp(cfg, p["mlp"], hn)


def embed_inputs(cfg, params, tokens, embeds=None):
    """Token embedding (+ modality-frontend stub embeddings for vlm).

    vlm: ``embeds`` (B, S_img, d) patch embeddings are prepended to the
    token embeddings (pixtral-style early fusion).
    """
    dtype = getattr(torch, cfg.dtype)
    if is_dtensor(params["embed"]):
        h = embedding_lookup(params["embed"], tokens.long()).to(dtype)
    else:
        h = params["embed"][tokens.long()].to(dtype)
    if embeds is not None:
        h = torch.cat([embeds.to(dtype), h], dim=1)
    return h


def _lm_head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor,
            embeds: torch.Tensor | None = None, remat=False):
    """Full forward pass.  Returns (hidden (B,S,d), aux_loss (f32 scalar,
    the MoE layers' summed router loss), logits_fn); with ``embeds`` (vlm)
    the hidden states cover the embeds' positions too.  ``remat``
    recomputes each layer (the hybrid's shared block excepted, as in the
    reference) in the backward."""
    check_remat(remat)
    groups = layer_groups(cfg)
    h = embed_inputs(cfg, params, tokens, embeds)
    h = shard(h, "batch", "seq_act", "embed")
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    resid0 = h
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for gi, grp in enumerate(groups):
        layers = unstack_layers(params[f"g{gi}"], grp.count)
        for li, lp in enumerate(layers):
            h, a = remat_call(remat, _apply_block, cfg, grp.kind, lp, h,
                              positions, remat == "save_collectives")
            aux = aux + a
            if grp.shared_attn and (li + 1) % cfg.shared_every == 0:
                h = _shared_block(cfg, params["shared"], h, resid0,
                                  positions)
    h = apply_norm(cfg, params["final_norm"], h)
    w = _lm_head(cfg, params)

    def logits_fn(hb):
        return hb @ w.to(hb.dtype)

    return h, aux, logits_fn


def lm_loss(cfg, params, tokens, targets, loss_mask, embeds=None,
            remat=True, xent_chunk=2048):
    """Mean next-token cross-entropy (``chunked_xent``) + 0.01 x the MoE
    aux loss; a vlm's ``embeds`` positions are padded out of the loss."""
    h, aux, logits_fn = forward(cfg, params, tokens, embeds, remat)
    if embeds is not None:
        # frontend positions produce no next-token loss
        n = embeds.shape[1]
        targets = torch.cat([targets.new_zeros((h.shape[0], n)), targets],
                            dim=1)
        loss_mask = torch.cat([loss_mask.new_zeros((h.shape[0], n)),
                               loss_mask], dim=1)
    t = h.shape[0] * h.shape[1]
    loss = chunked_xent(logits_fn, h.reshape(t, -1), targets.reshape(t),
                        loss_mask.reshape(t), chunk=xent_chunk)
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, b: int, seq_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """Per group: SSM states (f32, as in the reference), MLA latent caches
    or KV caches (a ring buffer of the window for SWA archs), stacked per
    layer; for hybrid archs one KV cache per shared-block invocation."""
    device = resolve_device(device)
    caches = {}
    for gi, grp in enumerate(layer_groups(cfg)):
        lead = (grp.count,)
        if grp.kind == "ssm":
            caches[f"g{gi}"] = ssm_mod.init_mamba2_cache(
                cfg, b, torch.float32, device, lead=lead)
        elif cfg.mla is not None:
            caches[f"g{gi}"] = attn.init_mla_cache(cfg, b, seq_len, dtype,
                                                   device, lead=lead)
        else:
            caches[f"g{gi}"] = attn.init_gqa_cache(cfg, b, seq_len, dtype,
                                                   device, lead=lead)
        if grp.shared_attn:
            caches["shared"] = attn.init_gqa_cache(
                cfg, b, seq_len, dtype, device,
                lead=(grp.count // cfg.shared_every,))
    return caches


def _decode_block(cfg, kind, p, h, position, cache):
    """One layer's decode step; attention caches are written in place, an
    SSM layer returns fresh ``state`` and ``conv`` tensors."""
    if kind == "ssm":
        hn = apply_norm(cfg, p["norm_ssm"], h)
        y, cache = ssm_mod.apply_mamba2_decode(cfg, p["ssm"], hn, cache)
        return h + y, cache
    hn = apply_norm(cfg, p["norm_attn"], h)
    if cfg.mla is not None:
        a, cache = attn.apply_mla_decode(cfg, p["attn"], hn, position, cache)
    else:
        a, cache = attn.apply_gqa_decode(cfg, p["attn"], hn, position, cache)
    h = h + a
    hn = apply_norm(cfg, p["norm_mlp"], h)
    if kind == "moe":
        y, _ = moe_mod.apply_moe(cfg, p["moe"], hn)
    else:
        y = apply_mlp(cfg, p["mlp"], hn)
    return h + y, cache


def decode_step(cfg: ArchConfig, params: dict, caches: dict,
                token: torch.Tensor, position: torch.Tensor):
    """One autoregressive step. token: (B, 1) int; position: (B,) int.
    Returns (logits (B, V) f32, caches) - ``caches`` updated in place."""
    h = embed_inputs(cfg, params, token)
    resid0 = h
    sh = params.get("shared")
    for gi, grp in enumerate(layer_groups(cfg)):
        gp, cache = params[f"g{gi}"], caches[f"g{gi}"]
        for li in range(grp.count):
            h, nc = _decode_block(cfg, grp.kind, index_layer(gp, li), h,
                                  position, index_layer(cache, li))
            if grp.kind == "ssm":
                cache["state"][li] = nc["state"]
                cache["conv"][li] = nc["conv"]
            if grp.shared_attn and (li + 1) % cfg.shared_every == 0:
                sc = index_layer(caches["shared"], li // cfg.shared_every)
                x = h + resid0
                hn = apply_norm(cfg, sh["norm_attn"], x)
                a, _ = attn.apply_gqa_decode(cfg, sh["attn"], hn, position,
                                             sc)
                x = x + a
                hn = apply_norm(cfg, sh["norm_mlp"], x)
                h = x + apply_mlp(cfg, sh["mlp"], hn)
    h = apply_norm(cfg, params["final_norm"], h)
    w = _lm_head(cfg, params)
    logits = (h[:, 0] @ w.to(h.dtype)).float()
    return logits, caches
