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


# ---------------------------------------------------------------------------
# The bf16 tensor-core body: its numerics in numpy, and its layout limits
# ---------------------------------------------------------------------------

def _bf16(x):
    """Round an f32 numpy array to bf16 (nearest even), kept as f32."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _tc_numerics(q, k, v, *, causal, window, bq=64, bk=64, split=True):
    """The arithmetic of ``flash_attention_fwd.cu``'s bf16 body in numpy, in
    its order: per query block, 64-key tiles from the first one that some
    row sees; f32 scores of bf16 operands, scaled in f32 by 1/sqrt(d) *
    log2 e; the -1e30 sentinel; running max and exp2; P V as two bf16
    products, hi = bf16(p) and lo = bf16(p - hi) (``split=False`` keeps hi
    alone); the row sum of the f32 p; f32 accumulation; O / l rounded to
    bf16 once.  q, k, v: f32 arrays holding bf16 values."""
    b, s, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    sc = np.float32(np.float32(d ** -0.5) * np.float32(1.4426950408889634))
    neg = np.float32(-1e30)
    out = np.zeros((b, s, h, dv), np.float32)
    for bi in range(b):
        for hi in range(h):
            hk = hi // (h // hkv)
            for q0 in range(0, s, bq):
                qb = q[bi, q0:q0 + bq, hi]
                rows = np.arange(q0, q0 + qb.shape[0])[:, None]
                k_hi = min(t, int(rows[-1, 0]) + 1) if causal else t
                k_lo = max(0, q0 - window + 1) if window else 0
                m = np.full(qb.shape[0], neg, np.float32)
                l = np.zeros(qb.shape[0], np.float32)
                acc = np.zeros((qb.shape[0], dv), np.float32)
                for k0 in range(k_lo // bk * bk, k_hi, bk):
                    kb, vb = k[bi, k0:k0 + bk, hk], v[bi, k0:k0 + bk, hk]
                    sco = (qb @ kb.T).astype(np.float32) * sc
                    kpos = np.arange(k0, k0 + kb.shape[0])[None, :]
                    ok = np.ones(sco.shape, bool)
                    if causal:
                        ok &= kpos <= rows
                    if window:
                        ok &= kpos > rows - window
                    sco = np.where(ok, sco, neg)
                    m_new = np.maximum(m, sco.max(axis=1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(sco - m_new[:, None])
                    p_hi = _bf16(p)
                    p_lo = _bf16(p - p_hi) if split else np.zeros_like(p)
                    l = l * alpha + p.sum(axis=1, dtype=np.float32)
                    acc = acc * alpha[:, None] + p_hi @ vb + p_lo @ vb
                    m = m_new
                out[bi, q0:q0 + bq, hi] = acc / np.maximum(l, 1e-30)[:, None]
    return _bf16(out)


def test_tensor_core_numerics_hold_the_prefill_bar():
    """bf16 P in P V keeps the bf16 body within the bar chip_smoke.py holds
    it to at the prefill's shapes (5e-3 of max |ref|), against the JAX
    reference kernel (interpret mode) at Zamba2's head width, causal."""
    rng = np.random.default_rng(13)
    b, s, h, hkv, d = 1, 512, 2, 1, 80
    arrs = [_bf16(rng.standard_normal(shape).astype(np.float32)) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d))]
    want = np.asarray(j_flash(*(jnp.asarray(a, dtype=jnp.bfloat16)
                                for a in arrs), causal=True, window=0),
                      np.float32)
    got = _tc_numerics(*arrs, causal=True, window=0)
    assert float(np.abs(got - want).max()) / float(np.abs(want).max()) < 5e-3
    plain = tkern.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs), causal=True)
    err = float(np.abs(got - plain.float().numpy()).max())
    assert err / float(np.abs(want).max()) < 5e-3


@pytest.mark.parametrize("case", [1, 5])
def test_tensor_core_numerics_masks_match_plain(case):
    """The emulation's window, ragged-T and GQA handling against the plain
    version on the sweep's window case and its bf16 case."""
    _, tx, causal, win, _ = _inputs(case)
    arrs = [_bf16(x.float().numpy()) for x in tx]
    got = _tc_numerics(*arrs, causal=causal, window=win)
    want = tkern.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs),
        causal=causal, window=win).float().numpy()
    assert float(np.abs(got - want).max()) < 2e-2


@pytest.mark.parametrize("shape", [c[:7] for c in SWEEP] +
                         [(2, 64, 64, 32, 32, 80, 80),
                          (2, 64, 64, 32, 8, 120, 120),
                          (1, 64, 64, 128, 128, 192, 128)])
def test_bf16_layout_takes_sweep_and_zamba2_shapes(shape):
    b, s, t, h, hkv, d, dv = shape
    xs = [torch.empty(sh, dtype=torch.bfloat16) for sh in
          ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, dv))]
    tkern.check_bf16_layout(d, dv, [x.data_ptr() for x in xs],
                            [x.stride()[:3] for x in xs])


@pytest.mark.parametrize("bad", ["d68", "d200", "dv12", "stride",
                                 "pointer", "seq_stride"])
def test_bf16_layout_raises(bad):
    q = torch.empty((1, 8, 2, 96), dtype=torch.bfloat16)
    d, dv, x = 80, 80, q[..., :80]
    if bad == "d68":
        d, x = 68, q[..., :68]
    elif bad == "d200":
        d, x = 200, torch.empty((1, 8, 2, 200), dtype=torch.bfloat16)
    elif bad == "dv12":
        dv = 12
    elif bad == "stride":
        x = torch.empty((1, 8, 2, 84), dtype=torch.bfloat16)[..., :80]
    elif bad == "pointer":
        x = q[..., 1:81]
    strides = [x.stride()[:3]]
    if bad == "seq_stride":
        strides = [(2 ** 26, tkern.MAX_SEQ_STRIDE, 96)]
    with pytest.raises(ValueError, match="bf16 flash kernel"):
        tkern.check_bf16_layout(d, dv, [x.data_ptr()], strides)


def test_bf16_body_by_width():
    """The instantiation each call takes: the exact d = dv = 80 one, the
    8-k-step one up to d = 128 (h2o-danube's 120 on a zeroed pad chunk),
    the 12-k-step one above (deepseek-v3's MLA, 192 / 128); f32 the CUDA
    cores."""
    bf16 = torch.bfloat16
    assert tkern.fa_body(bf16, 80, 80) == "tc_exact"
    assert tkern.fa_body(bf16, 80, 24) == "tc_k8"
    assert tkern.fa_body(bf16, 120, 120) == "tc_k8"
    assert tkern.fa_body(bf16, 128, 128) == "tc_k8"
    assert tkern.fa_body(bf16, 192, 128) == "tc_k12"
    assert tkern.fa_body(torch.float32, 192, 128) == "cuda_core"
    assert set(tkern.flash_attention_fwd.body_launches) == set(tkern.BODIES)


def test_split_p_halves_the_rounding_error():
    """Why the kernel multiplies V by P's hi and lo bf16 halves: at
    Zamba2's heads (B=2, H=32, d=80, causal, 128 rows), P rounded once
    comes near the 5e-3 bar against the f32 plain version; the split at
    least halves the error."""
    rng = np.random.default_rng(1)
    arrs = [_bf16(rng.standard_normal((2, 128, 32, 80)).astype(np.float32))
            for _ in range(3)]
    want = tkern.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs),
        causal=True).float().numpy()
    scale = float(np.abs(want).max())
    err = {split: float(np.abs(_tc_numerics(*arrs, causal=True, window=0,
                                            split=split) - want).max())
           / scale for split in (False, True)}
    assert err[True] < 5e-3 and err[True] < err[False] / 1.5, err


def _chip_smoke():
    """``chip_smoke.py`` at the repository root, as a module."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("split", [True, False])
def test_row_measure_needs_the_split(split):
    """chip_smoke.py's row-by-row measure of the bf16 body at the prefill's
    shapes (error beyond the output's own rounding, over the row's max
    |ref|, against the f32 plain version) passes the emulated body with
    P's hi and lo halves and fails it, by more than 10x its bar, with the
    hi half alone, at d = 80, causal."""
    cs = _chip_smoke()
    rng = np.random.default_rng(0)
    arrs = [_bf16(rng.standard_normal((1, 512, 4, 80)).astype(np.float32))
            for _ in range(3)]
    want32 = tkern.flash_attention_plain(
        *(torch.from_numpy(a) for a in arrs), causal=True)
    got = torch.from_numpy(_tc_numerics(*arrs, causal=True, window=0,
                                        split=split)).to(torch.bfloat16)
    err = cs.fa_beyond_rounding(torch, got, want32)
    if split:
        assert err < cs.FA_MAIN_ROW_BAR, err
    else:
        assert err > 10 * cs.FA_MAIN_ROW_BAR, err
