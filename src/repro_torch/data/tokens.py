"""Synthetic LM data pipeline (port of ``repro.data.tokens``, the port's own
numpy copy).

Deterministic, seekable, infinite: batch i is a pure function of (seed, i),
so a restarted job regenerates exactly the batches it would have seen (a
checkpoint stores only the step index - no data-loader state), bitwise
equal to the reference's.  The token stream is a Zipf-ish unigram mix
with induced bigram structure, so models show a real (falling) loss curve
rather than log(V) noise.  Batches are numpy; :func:`to_tensors` moves one
to a device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import encdec as encdec_mod
from repro_torch.models.config import ArchConfig


def _tokens(rng, b, s, vocab):
    # Zipfian unigrams + deterministic bigram transitions for learnability
    v_eff = min(vocab, 4096)
    base = rng.zipf(1.3, size=(b, s)).clip(1, v_eff) - 1
    shift = np.roll(base, 1, axis=1) * 7 % v_eff
    mix = rng.random((b, s)) < 0.5
    return np.where(mix, base, shift).astype(np.int32)


def synthetic_batches(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                      start: int = 0):
    """Yields loss-ready batches in ``models.lm.input_specs``' layouts,
    from batch ``start`` on (a resumed run seeks to its step)."""
    i = start
    while True:
        rng = np.random.default_rng((seed, i))
        if cfg.family == "audio":
            st = seq // encdec_mod.TGT_RATIO
            toks = _tokens(rng, batch, st + 1, cfg.vocab)
            yield {
                "src_embeds": rng.standard_normal(
                    (batch, seq, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:],
                "mask": np.ones((batch, st), np.float32),
            }
        elif cfg.family == "vlm":
            si = int(seq * cfg.frontend_frac)
            stx = seq - si
            toks = _tokens(rng, batch, stx + 1, cfg.vocab)
            yield {
                "embeds": rng.standard_normal(
                    (batch, si, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:],
                "mask": np.ones((batch, stx), np.float32),
            }
        else:
            toks = _tokens(rng, batch, seq + 1, cfg.vocab)
            yield {
                "tokens": toks[:, :-1],
                "targets": toks[:, 1:],
                "mask": np.ones((batch, seq), np.float32),
            }
        i += 1


def to_tensors(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (dtypes kept: the models cast
    embeddings to the config's dtype)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
