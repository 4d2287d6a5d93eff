"""Top-level LM API (port of ``repro.models.lm``): input specs, loss,
prefill and decode builders, parameter init and the key map from the
reference's pytree.

Family dispatch (decoder-only vs encoder-decoder vs ssm/hybrid) is resolved
here, as in the reference.  Parameters are a plain nested dict of tensors
whose keys are the reference's pytree paths, so a JAX parameter tree of any
family converts key for key.  The dry-run helpers (``input_specs``,
``cache_specs``, ``abstract_params``) give meta-device tensors, the port's
``ShapeDtypeStruct``.  ``make_loss_fn`` trains every family: attention
through the flash kernels' forward and backward, the Mamba-2 blocks of the
ssm and hybrid families through the SSD chunk kernel's forward and
backward.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-not). long_500k needs sub-quadratic attention.
    The reason is the reference's, word for word (the dry run's skip
    records name it)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token KV decode is "
                       "quadratic-memory; skipped per assignment "
                       "(DESIGN.md §Arch-applicability)")
    return True, ""


def _frontend_split(cfg: ArchConfig, seq: int) -> tuple[int, int]:
    """(n_frontend_positions, n_text_positions) for vlm archs."""
    s_img = int(seq * cfg.frontend_frac)
    return s_img, seq - s_img


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-device stand-ins for every model input (no allocation), in
    the layouts ``data.tokens.synthetic_batches`` yields."""
    b, s = shape.global_batch, shape.seq_len
    f, i32 = getattr(torch, cfg.dtype), torch.int32

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            st = s // encdec_mod.TGT_RATIO
            return {"src_embeds": spec((b, s, cfg.d_model), f),
                    "tokens": spec((b, st), i32),
                    "targets": spec((b, st), i32),
                    "mask": spec((b, st), torch.float32)}
        if cfg.family == "vlm":
            si, stxt = _frontend_split(cfg, s)
            return {"embeds": spec((b, si, cfg.d_model), f),
                    "tokens": spec((b, stxt), i32),
                    "targets": spec((b, stxt), i32),
                    "mask": spec((b, stxt), torch.float32)}
        return {"tokens": spec((b, s), i32), "targets": spec((b, s), i32),
                "mask": spec((b, s), torch.float32)}
    # decode: one new token against a seq_len cache
    return {"token": spec((b, 1), i32), "position": spec((b,), i32)}


def cache_specs(cfg: ArchConfig, shape: ShapeSpec, dtype=torch.bfloat16):
    """Abstract KV/state caches for decode, on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        return encdec_mod.init_caches(cfg, b, s // encdec_mod.TGT_RATIO, s,
                                      dtype, "meta")
    return tfm.init_caches(cfg, b, s, dtype, "meta")


def make_loss_fn(cfg: ArchConfig, remat: bool = True,
                 xent_chunk: int = 2048):
    """``loss_fn(params, batch)`` -> scalar f32 loss (the batch holds
    tensors in ``input_specs``' layout).  The reference's ``kv_chunk`` has
    no counterpart: the flash kernels replace ``chunked_attention``.  The
    reference trains its ssm and hybrid families through the jnp
    ``ssd_chunked``; the port through the SSD kernels' autograd Function
    (``kernels/ssd/kernel.py:ssd_chunk_step``)."""
    if cfg.family == "audio":
        def loss_fn(params, batch):
            return encdec_mod.lm_loss(
                cfg, params, batch["tokens"], batch["targets"],
                batch["mask"], batch["src_embeds"], remat, xent_chunk)
        return loss_fn

    def loss_fn(params, batch):
        return tfm.lm_loss(cfg, params, batch["tokens"], batch["targets"],
                           batch["mask"], batch.get("embeds"), remat,
                           xent_chunk)
    return loss_fn


def make_prefill_fn(cfg: ArchConfig):
    """Prefill: full forward, returns last-position logits (f32).  The
    batch holds ``tokens``, and ``embeds`` (vlm: prepended patch
    embeddings) or ``src_embeds`` (audio: the encoder's frames; ``tokens``
    are then the decoder's)."""
    if cfg.family == "audio":
        def prefill(params, batch):
            h, _, logits_fn = encdec_mod.forward(
                cfg, params, batch["tokens"], batch["src_embeds"])
            return logits_fn(h[:, -1]).float()
        return prefill

    def prefill(params, batch):
        h, _, logits_fn = tfm.forward(cfg, params, batch["tokens"],
                                      batch.get("embeds"))
        return logits_fn(h[:, -1]).float()
    return prefill


def make_decode_fn(cfg: ArchConfig):
    """One decode step: ``decode(params, caches, {"token", "position"})``
    -> (logits, caches), the caches updated in place."""
    step = (encdec_mod.decode_step if cfg.family == "audio" else
            tfm.decode_step)

    def decode(params, caches, batch):
        return step(cfg, params, caches, batch["token"], batch["position"])
    return decode


def init_params(cfg: ArchConfig, generator: torch.Generator | None, *,
                tp: int = 16, dtype=None, device="cuda") -> dict:
    """Random parameters drawn from ``generator`` (on ``device``); heads are
    padded to a multiple of ``tp`` as in the reference.  ``device="meta"``
    builds the shapes only (``generator`` may then be None)."""
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    if generator is None and dev.type != "meta":
        raise ValueError("init_params needs a generator off the meta device")
    if cfg.family == "audio":
        return encdec_mod.init_encdec(cfg, generator, tp, dtype, dev)
    return tfm.init_lm(cfg, generator, tp, dtype, dev)


def abstract_params(cfg: ArchConfig, tp: int = 16, dtype=None) -> dict:
    """The parameter tree as meta-device tensors (no allocation)."""
    return init_params(cfg, None, tp=tp, dtype=dtype, device="meta")


def _leaf(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(dev)


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        out |= _keys(v, path) if isinstance(v, dict) else {path}
    return out


def params_from_jax(cfg: ArchConfig, tree: dict, *, device="cuda") -> dict:
    """The reference's parameter pytree (nested dicts of numpy arrays) as the
    port's parameters, key for key, each leaf keeping its dtype (``a_log``,
    ``dt_bias``, ``d_skip`` and the MoE router stay f32 under a bf16
    config): stacked layers, stacked experts, MLA's leaves and the
    encoder-decoder's ``enc``/``dec`` trees alike.  Raises if the keys
    differ from the port's layout for ``cfg``."""
    dev = resolve_device(device)
    want = _keys(init_params(cfg, None, device="meta"))
    got = _keys(tree)
    if want != got:
        raise KeyError(f"parameter keys differ: missing "
                       f"{sorted(want - got)}, unexpected {sorted(got - want)}")

    def convert(t):
        return {k: convert(v) if isinstance(v, dict) else _leaf(v, dev)
                for k, v in t.items()}
    return convert(tree)
