"""The port's flash attention and ``chunked_attention`` against the JAX
package.

The JAX Pallas kernel runs in interpret mode, its default on the CPU
(``repro.kernels.attention.ops``).  Both packages get the same numpy inputs
on the six sweep cases of ``tests/test_kernels_attention.py`` (window,
non-causal, dv != d, ragged T, GQA, bf16); bf16 cases cast the same f32
draws in both.  Tolerances are the JAX suite's own: 2e-5 absolute in f32
(outputs are O(1)), 2e-2 in bf16.  The CUDA kernel itself runs only on the
card, where ``chip_smoke.py`` holds it against ``flash_attention_plain``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ops import flash_attention as j_flash
from repro.kernels.attention.ref import attention_ref as j_attention_ref
from repro.models import attention as jattn
from repro_torch.kernels.attention import kernel as tkern
from repro_torch.models import attention as tattn

SWEEP = [
    # b, s, t, h, hkv, d, dv, causal, window, dtype
    (2, 64, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 48, 80, 4, 4, 16, 16, True, 16, "float32"),
    (2, 32, 64, 2, 1, 32, 32, False, 0, "float32"),
    (1, 40, 40, 8, 2, 64, 64, True, 0, "float32"),
    (1, 64, 64, 4, 1, 32, 16, True, 0, "float32"),   # MLA-style dv != d
    (2, 64, 64, 4, 2, 32, 32, True, 0, "bfloat16"),
]


def _inputs(case):
    b, s, t, h, hkv, d, dv, causal, win, dt = SWEEP[case]
    rng = np.random.default_rng(case)
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, dv))]
    jx = [jnp.asarray(a, dtype=jnp.dtype(dt)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dt)) for a in arrs]
    return jx, tx, causal, win, dt


def _err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_flash_matches_jax(case):
    (q, k, v), tx, causal, win, dt = _inputs(case)
    want = j_flash(q, k, v, causal=causal, window=win, bq=16, bk=16)
    tol = 2e-5 if dt == "float32" else 2e-2
    plain = tkern.flash_attention_plain(*tx, causal=causal, window=win)
    wrapper = tkern.flash_attention_fwd(*tx, causal=causal, window=win)
    assert plain.dtype == tx[0].dtype
    assert tuple(plain.shape) == want.shape
    assert _err(plain, want) < tol, (case, _err(plain, want))
    assert torch.equal(wrapper, plain)


@pytest.mark.parametrize("case", [0, 1, 4])
def test_attention_ref_matches_jax(case):
    """The plain version against the reference's naive-softmax oracle,
    which materialises the whole (S, T) block."""
    (q, k, v), tx, causal, win, _ = _inputs(case)
    b, s, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]

    def bh(x, heads, length, width):
        return x.transpose(0, 2, 1, 3).reshape(b * heads, length, width)
    want = j_attention_ref(bh(q, h, s, d), bh(k, hkv, t, d),
                           bh(v, hkv, t, dv), causal=causal, window=win)
    want = want.reshape(b, h, s, dv).transpose(0, 2, 1, 3)
    got = tkern.flash_attention_plain(*tx, causal=causal, window=win)
    assert _err(got, want) < 2e-5


@pytest.mark.parametrize("window", [0, 16])
def test_chunked_attention_matches_jax_and_flash(window):
    """The reference's model attention, ported plain, against JAX; and the
    flash path (what ``apply_gqa`` now calls) against it at arange
    positions, as ``test_flash_matches_model_chunked_attention`` does."""
    rng = np.random.default_rng(7)
    b, s, h, hkv, d = 2, 64, 4, 2, 32
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in arrs),
                                   jnp.asarray(pos), jnp.asarray(pos),
                                   window=window, kv_chunk=16)
    tx = [torch.from_numpy(a) for a in arrs]
    tpos = torch.from_numpy(pos.copy())
    got = tattn.chunked_attention(*tx, tpos, tpos, window=window,
                                  kv_chunk=16)
    assert _err(got, want) < 2e-5
    flash = tkern.flash_attention_fwd(*tx, causal=True, window=window)
    assert float((flash - got).abs().max()) < 2e-5


def test_wrapper_dispatch_on_cpu_counts_no_launch():
    _, tx, causal, win, _ = _inputs(0)
    before = tkern.flash_attention_fwd.launches
    tkern.flash_attention_fwd(*tx, causal=causal, window=win)
    assert tkern.flash_attention_fwd.launches == before


def test_plain_version_walks_query_blocks(monkeypatch):
    """Row blocks (bounded memory) give the same answer as one block."""
    (q, k, v), tx, causal, win, _ = _inputs(1)
    whole = tkern.flash_attention_plain(*tx, causal=causal, window=win)
    monkeypatch.setattr(tkern, "PLAIN_ROWS", 7)
    blocked = tkern.flash_attention_plain(*tx, causal=causal, window=win)
    assert float((whole - blocked).abs().max()) < 1e-6
