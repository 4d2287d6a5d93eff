"""Decoder-only LM for the ``ssm`` and ``hybrid`` families (port of
``repro.models.transformer``).

Layers of a group are stacked along a leading dimension as in the reference;
where it runs ``lax.scan`` over them the port loops over the layer index.
Sharding annotations, ``checkpoint_name`` and remat have no counterpart in
single-card serving and are dropped.  Decode updates its caches in place
and returns the same dictionary.

The dense, moe, mla, vlm and audio families raise ``NotImplementedError``:
ROADMAP §1 item 15 ports them.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_mlp, apply_norm, init_mlp,
                                       init_norm, normal)
from repro_torch.models.config import ArchConfig
from repro_torch.utils.device import resolve_device

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kind: str          # 'ssm' (the port's families)
    count: int
    shared_attn: bool = False   # hybrid: shared attn+mlp every shared_every


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("ssm", "hybrid") or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; ROADMAP "
            "§1 item 15 ports the dense, moe, mla, vlm and audio families")


def layer_groups(cfg: ArchConfig) -> list[LayerGroup]:
    _check_family(cfg)
    return [LayerGroup("ssm", cfg.n_layers,
                       shared_attn=cfg.family == "hybrid")]


def _stack(tree, n: int):
    """``tree`` with every leaf repeated along a new leading dim of n."""
    return {k: _stack(v, n) if isinstance(v, dict) else
            v.expand(n, *v.shape).clone() for k, v in tree.items()}


def index_layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views)."""
    return {k: index_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

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
        params[f"g{gi}"] = {
            "norm_ssm": _stack(init_norm(cfg, d, dtype, device), grp.count),
            "ssm": ssm_mod.init_mamba2(cfg, generator, dtype, device,
                                       lead=(grp.count,)),
        }
    if cfg.family == "hybrid":
        params["shared"] = {
            "norm_attn": init_norm(cfg, d, dtype, device),
            "attn": attn.init_gqa(cfg, generator, tp, dtype, device),
            "norm_mlp": init_norm(cfg, d, dtype, device),
            "mlp": init_mlp(cfg, generator, d, cfg.d_ff, dtype, device),
        }
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _apply_block(cfg, p, h):
    hn = apply_norm(cfg, p["norm_ssm"], h)
    return h + ssm_mod.apply_mamba2(cfg, p["ssm"], hn)


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


def embed_inputs(cfg, params, tokens):
    """Token embedding (the vlm / audio frontends wait for their slice)."""
    return params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))


def _lm_head(cfg, params):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward(cfg: ArchConfig, params: dict, tokens: torch.Tensor):
    """Full forward pass. Returns (hidden (B,S,d), logits_fn)."""
    groups = layer_groups(cfg)
    h = embed_inputs(cfg, params, tokens)
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    resid0 = h
    for gi, grp in enumerate(groups):
        gp = params[f"g{gi}"]
        for li in range(grp.count):
            h = _apply_block(cfg, index_layer(gp, li), h)
            if grp.shared_attn and (li + 1) % cfg.shared_every == 0:
                h = _shared_block(cfg, params["shared"], h, resid0,
                                  positions)
    h = apply_norm(cfg, params["final_norm"], h)
    w = _lm_head(cfg, params)

    def logits_fn(hb):
        return hb @ w.to(hb.dtype)

    return h, logits_fn


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, b: int, seq_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """SSM states (f32, as in the reference) per layer and, for hybrid
    archs, one KV cache per shared-block invocation."""
    device = resolve_device(device)
    caches = {}
    for gi, grp in enumerate(layer_groups(cfg)):
        caches[f"g{gi}"] = ssm_mod.init_mamba2_cache(
            cfg, b, torch.float32, device, lead=(grp.count,))
        if grp.shared_attn:
            caches["shared"] = attn.init_gqa_cache(
                cfg, b, seq_len, dtype, device,
                lead=(grp.count // cfg.shared_every,))
    return caches


def decode_step(cfg: ArchConfig, params: dict, caches: dict,
                token: torch.Tensor, position: torch.Tensor):
    """One autoregressive step. token: (B, 1) int; position: (B,) int.
    Returns (logits (B, V) f32, caches) - ``caches`` updated in place."""
    h = params["embed"][token.long()].to(getattr(torch, cfg.dtype))
    resid0 = h
    sh = params.get("shared")
    for gi, grp in enumerate(layer_groups(cfg)):
        gp, cache = params[f"g{gi}"], caches[f"g{gi}"]
        for li in range(grp.count):
            lp = index_layer(gp, li)
            hn = apply_norm(cfg, lp["norm_ssm"], h)
            y, nc = ssm_mod.apply_mamba2_decode(cfg, lp["ssm"], hn,
                                                index_layer(cache, li))
            h = h + y
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
