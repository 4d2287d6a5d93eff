"""Encoder-decoder transformer (seamless-m4t backbone; port of
``repro.models.encdec``).

The audio frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (B, S_src, d) to the encoder.  The encoder is
bidirectional: its attention is the flash kernel with ``causal=False``
(the reference sets every key position to 0).  The text decoder runs
causal self-attention through :func:`attention.apply_gqa` and
cross-attention through the flash kernel, non-causal, over the encoder's
S_src keys (S != T), with no RoPE on its query.  Training differentiates
all three through the flash kernels' autograd Function; ``remat``
recomputes each encoder and decoder layer (the decoder layer's cross K/V
projection included) in the backward, as the reference's
``jax.checkpoint`` of each scanned layer.  Decode runs the decoder
with a self KV cache, updated in place, and cross K/V precomputed from the
encoder output (:func:`fill_cross_kv`).  Decoder target length = S_src //
4 (``TGT_RATIO``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_mlp, apply_norm, chunked_xent,
                                       init_mlp, init_norm, normal)
from repro_torch.models.config import ArchConfig
from repro_torch.parallel.sharding import shard
from repro_torch.models.transformer import (_stack, check_remat,
                                            embed_inputs, index_layer,
                                            padded_vocab, remat_call,
                                            unstack_layers)
from repro_torch.utils.device import resolve_device

TGT_RATIO = 4  # source frames per target token


def _init_layers(cfg, generator, tp, dtype, device, n: int, cross: bool):
    """n stacked layers; decoder layers (``cross``) add cross-attention."""
    d = cfg.d_model
    p = {"norm_attn": _stack(init_norm(cfg, d, dtype, device), n),
         "attn": attn.init_gqa(cfg, generator, tp, dtype, device, lead=(n,)),
         "norm_mlp": _stack(init_norm(cfg, d, dtype, device), n),
         "mlp": init_mlp(cfg, generator, d, cfg.d_ff, dtype, device,
                         lead=(n,))}
    if cross:
        p["norm_xattn"] = _stack(init_norm(cfg, d, dtype, device), n)
        p["xattn"] = attn.init_gqa(cfg, generator, tp, dtype, device,
                                   lead=(n,))
    return p


def init_encdec(cfg: ArchConfig, generator, tp: int, dtype, device) -> dict:
    vp = padded_vocab(cfg.vocab)
    d = cfg.d_model
    return {
        "embed": normal(generator, (vp, d), d ** -0.5, dtype, device),
        "lm_head": normal(generator, (d, vp), d ** -0.5, dtype, device),
        "enc": _init_layers(cfg, generator, tp, dtype, device,
                            cfg.encoder_layers, False),
        "dec": _init_layers(cfg, generator, tp, dtype, device, cfg.n_layers,
                            True),
        "enc_norm": init_norm(cfg, d, dtype, device),
        "final_norm": init_norm(cfg, d, dtype, device),
    }


def _enc_block(cfg, p, h, positions):
    hn = apply_norm(cfg, p["norm_attn"], h)
    q, k, v = attn._qkv(cfg, p["attn"], hn, positions)
    out = attn.attend(q, k, v, causal=False,            # bidirectional
                      fa=flash_attention)
    h = h + attn._out(out, p["attn"]["wo"])
    hn = apply_norm(cfg, p["norm_mlp"], h)
    return shard(h + apply_mlp(cfg, p["mlp"], hn), "batch", None, "embed")


def _enc_kv(p_dec_layer, enc_out):
    """A decoder layer's cross K/V over the encoder output (no bias, no
    RoPE, as in the reference)."""
    xa = p_dec_layer["xattn"]
    return attn._proj(enc_out, xa["wk"]), attn._proj(enc_out, xa["wv"])


def _dec_block(cfg, p, h, enc_kv, positions):
    hn = apply_norm(cfg, p["norm_attn"], h)
    a, _ = attn.apply_gqa(cfg, p["attn"], hn, positions)
    h = h + a
    hn = apply_norm(cfg, p["norm_xattn"], h)
    q = attn._proj(hn, p["xattn"]["wq"])
    out = attn.attend(q, *enc_kv, causal=False,         # S_tgt x S_src
                      fa=flash_attention)
    h = h + attn._out(out, p["xattn"]["wo"])
    hn = apply_norm(cfg, p["norm_mlp"], h)
    return shard(h + apply_mlp(cfg, p["mlp"], hn), "batch", None, "embed")


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(cfg: ArchConfig, params: dict, src_embeds: torch.Tensor,
           remat=False):
    """Encoder output (B, S_src, d), after ``enc_norm``."""
    check_remat(remat)
    h = src_embeds.to(getattr(torch, cfg.dtype))
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for lp in unstack_layers(params["enc"], cfg.encoder_layers):
        h = remat_call(remat, _enc_block, cfg, lp, h, positions)
    return apply_norm(cfg, params["enc_norm"], h)


def _dec_layer(cfg, lp, h, enc_out, positions):
    """A decoder layer with its cross K/V projection (one remat unit)."""
    return _dec_block(cfg, lp, h, _enc_kv(lp, enc_out), positions)


def forward(cfg: ArchConfig, params: dict, tgt_tokens: torch.Tensor,
            src_embeds: torch.Tensor, remat=False):
    """Returns (hidden (B, S_tgt, d), aux = 0, logits_fn)."""
    enc_out = encode(cfg, params, src_embeds, remat)
    h = embed_inputs(cfg, params, tgt_tokens)
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for lp in unstack_layers(params["dec"], cfg.n_layers):
        h = remat_call(remat, _dec_layer, cfg, lp, h, enc_out, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    w = params["lm_head"]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    def logits_fn(hb):
        return hb @ w.to(hb.dtype)

    return h, aux, logits_fn


def lm_loss(cfg, params, tgt_tokens, targets, loss_mask, src_embeds,
            remat=True, xent_chunk=2048):
    """Mean next-token cross-entropy of the decoder (no aux loss, as in
    the reference)."""
    h, _, logits_fn = forward(cfg, params, tgt_tokens, src_embeds, remat)
    t = h.shape[0] * h.shape[1]
    return chunked_xent(logits_fn, h.reshape(t, -1), targets.reshape(t),
                        loss_mask.reshape(t), chunk=xent_chunk)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, b: int, tgt_len: int, src_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """Decoder self-attention caches and the cross K/V of every layer
    (zeros until :func:`fill_cross_kv`)."""
    device = resolve_device(device)
    n = cfg.n_layers
    kw = dict(dtype=dtype, device=device)
    return {
        "self": attn.init_gqa_cache(cfg, b, tgt_len, dtype, device,
                                    lead=(n,)),
        "cross_k": torch.zeros((n, b, src_len, cfg.kv_heads, cfg.hd), **kw),
        "cross_v": torch.zeros((n, b, src_len, cfg.kv_heads, cfg.hd), **kw),
    }


def fill_cross_kv(cfg: ArchConfig, params: dict, caches: dict,
                  src_embeds: torch.Tensor) -> dict:
    """Encode ``src_embeds`` and write each decoder layer's cross K/V into
    ``caches`` (in place; returned)."""
    enc_out = encode(cfg, params, src_embeds)
    for li in range(cfg.n_layers):
        k, v = _enc_kv(index_layer(params["dec"], li), enc_out)
        caches["cross_k"][li] = k.to(caches["cross_k"].dtype)
        caches["cross_v"][li] = v.to(caches["cross_v"].dtype)
    return caches


def decode_step(cfg: ArchConfig, params: dict, caches: dict,
                token: torch.Tensor, position: torch.Tensor):
    """One decoder step. token: (B, 1) int; position: (B,) int.  Returns
    (logits (B, V) f32, caches) - the self caches updated in place."""
    h = params["embed"][token.long()].to(getattr(torch, cfg.dtype))
    b = h.shape[0]
    for li in range(cfg.n_layers):
        lp = index_layer(params["dec"], li)
        hn = apply_norm(cfg, lp["norm_attn"], h)
        a, _ = attn.apply_gqa_decode(cfg, lp["attn"], hn, position,
                                     index_layer(caches["self"], li))
        h = h + a
        hn = apply_norm(cfg, lp["norm_xattn"], h)
        # cross attention against the full (precomputed) encoder K/V
        ck, cv = caches["cross_k"][li], caches["cross_v"][li]
        q = attn._proj(hn, lp["xattn"]["wq"])[:, 0]         # (B, H, hd)
        hkv, hd = ck.shape[2], ck.shape[3]
        rep = q.shape[1] // hkv
        qf = (q * cfg.hd ** -0.5).float().view(b, hkv, rep, hd)
        sco = torch.einsum("bgrk,btgk->bgrt", qf, ck.float())
        prob = torch.softmax(sco, dim=-1)
        out = torch.einsum("bgrt,btgk->bgrk", prob, cv.float()).reshape(
            b, -1, hd)
        h = h + attn._out(out.to(h.dtype), lp["xattn"]["wo"])[:, None, :]
        hn = apply_norm(cfg, lp["norm_mlp"], h)
        h = h + apply_mlp(cfg, lp["mlp"], hn)
    h = apply_norm(cfg, params["final_norm"], h)
    logits = (h[:, 0] @ params["lm_head"].to(h.dtype)).float()
    return logits, caches
