"""The port's flash-attention gradient against the JAX package.

``flash_attention_bwd_plain`` (the plain version of the backward kernel
``csrc/flash_attention_bwd.cu``) against ``jax.vjp`` of the reference's
naive-softmax oracle ``repro.kernels.attention.ref.attention_ref`` in its
(B*H, S, d) layout, on the same numpy inputs and upstream gradient at f32,
within 1e-5 of each output's max |ref| (the reference materialises the
whole (S, T) block; the plain version walks ``PLAIN_ROWS`` query rows).
The cases are the sweep of ``tests/test_torch_attention.py`` (window,
non-causal S != T, GQA, dv != d, ragged T) and the zoo's widths of
``tests/test_torch_lm_zoo.py`` (d = 120 with a window, d = 192 with
dv = 128, non-causal S != T).  The forward's ``lse`` is held against a
direct log-sum-exp, and the autograd Function ``flash_attention`` on CPU
tensors against ``torch.autograd`` through ``flash_attention_plain``.  The
CUDA kernels run only on the card, where ``chip_smoke.py`` (phase S) holds
them against these plain versions.  Here the bf16 tensor-core body's
rounding is emulated in torch f32 (``_tc_bwd_numerics``) and held, as
phase S holds the kernel, against the plain version in bf16 (5e-3 of each
output's max |ref|), and once against ``jax.vjp`` of the reference's
``chunked_attention``; its body rule and layout checks are checked too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref
from repro.models.attention import chunked_attention
from repro_torch.kernels.attention import kernel as tkern
from torch_one_thread import one_torch_thread  # noqa: F401

CASES = {   # b, s, t, h, hkv, d, dv, causal, window
    "gqa": (2, 64, 64, 4, 2, 32, 32, True, 0),
    "window_ragged_t": (1, 48, 80, 4, 4, 16, 16, True, 16),
    "noncausal": (2, 32, 64, 2, 1, 32, 32, False, 0),
    "gqa4": (1, 40, 40, 8, 2, 64, 64, True, 0),
    "dv_ne_d": (1, 64, 64, 4, 1, 32, 16, True, 0),
    "d120_window": (1, 40, 40, 4, 2, 120, 120, True, 16),
    "d192_dv128": (1, 32, 32, 4, 4, 192, 128, True, 0),
    "noncausal_s_ne_t": (2, 24, 56, 4, 4, 64, 64, False, 0),
}
BAR = 1e-5


def _arrays(name):
    b, s, t, h, hkv, d, dv, causal, win = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q, k, v, do = (rng.standard_normal(sh).astype(np.float32) for sh in
                   ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, dv),
                    (b, s, h, dv)))
    return (q, k, v, do), dict(causal=causal, window=win)


def _bh(x):
    """(B, L, H, w) -> (B*H, L, w), the reference kernel's layout."""
    b, n, h, w = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, n, w)


def _from_bh(x, b):
    bh, n, w = x.shape
    return np.asarray(x).reshape(b, bh // b, n, w).transpose(0, 2, 1, 3)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """The reference's output and vjp, and the plain forward with lse."""
    (q, k, v, do), mask = _arrays(request.param)
    out, vjp = jax.vjp(lambda a, b_, c: attention_ref(a, b_, c, **mask),
                       *(jnp.asarray(_bh(x)) for x in (q, k, v)))
    grads = [_from_bh(g, q.shape[0]) for g in vjp(jnp.asarray(_bh(do)))]
    tx = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = tkern.flash_attention_plain(*tx[:3], **mask, return_lse=True)
    return dict(name=request.param, arrays=(q, k, v, do), tx=tx, mask=mask,
                want_out=_from_bh(out, q.shape[0]), want_grads=grads, o=o,
                lse=lse)


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_bwd_plain_matches_jax_vjp(case):
    q, k, v, do = case["tx"]
    got = tkern.flash_attention_bwd_plain(q, k, v, case["o"], case["lse"],
                                          do, **case["mask"])
    assert _rel(case["o"].numpy(), case["want_out"]) < BAR
    for name, g, w in zip(("dq", "dk", "dv"), got, case["want_grads"]):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g.numpy(), w) < BAR, (case["name"], name,
                                          _rel(g.numpy(), w))


def test_plain_lse_is_the_rows_logsumexp(case):
    """lse (B, H, S) is log sum_k exp(q.k / sqrt(d)) over each row's
    visible keys (f64 in numpy)."""
    q, k = (x.astype(np.float64) for x in case["arrays"][:2])
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    mask = case["mask"]
    kk = np.repeat(k, h // hkv, axis=2)
    sco = np.einsum("bshd,bthd->bhst", q, kk) * d ** -0.5
    qp, kp = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if mask["causal"]:
        ok &= kp <= qp
    if mask["window"]:
        ok &= kp > qp - mask["window"]
    sco = np.where(ok, sco, -np.inf)
    m = sco.max(-1, keepdims=True)
    want = (m + np.log(np.exp(sco - m).sum(-1, keepdims=True)))[..., 0]
    got = case["lse"].numpy()
    assert got.shape == (b, h, s) and case["lse"].dtype == torch.float32
    assert float(np.abs(got - want).max()) < 1e-5 * max(
        1.0, float(np.abs(want).max()))


def test_autograd_function_matches_plain_autograd(case):
    """``flash_attention`` under autograd (the Function: forward with lse,
    the backward wrapper, plain versions on the CPU) against autograd
    through ``flash_attention_plain``."""
    q, k, v, do = case["tx"]
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tkern.flash_attention(*leaves, **case["mask"])
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), case["o"])
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(
        tkern.flash_attention_plain(*ref_leaves, **case["mask"]),
        ref_leaves, do)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < BAR


def test_flash_attention_without_grad_is_the_forward():
    """No input needing a gradient, or no_grad: the forward wrapper alone,
    with no autograd node (what serving launches)."""
    (q, k, v, _), mask = _arrays("gqa")
    tx = [torch.from_numpy(x) for x in (q, k, v)]
    out = tkern.flash_attention(*tx, **mask)
    assert out.grad_fn is None
    assert torch.equal(out, tkern.flash_attention_fwd(*tx, **mask))
    with torch.no_grad():
        leaves = [x.clone().requires_grad_(True) for x in tx]
        assert tkern.flash_attention(*leaves, **mask).grad_fn is None


def test_bwd_plain_walks_query_blocks(monkeypatch):
    """Row blocks (bounded memory) give the same gradients as one block."""
    (q, k, v, do), mask = _arrays("window_ragged_t")
    tx = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = tkern.flash_attention_plain(*tx[:3], **mask, return_lse=True)
    whole = tkern.flash_attention_bwd_plain(*tx[:3], o, lse, tx[3], **mask)
    monkeypatch.setattr(tkern, "PLAIN_ROWS", 7)
    o7, lse7 = tkern.flash_attention_plain(*tx[:3], **mask, return_lse=True)
    assert float((lse7 - lse).abs().max()) < 1e-6
    blocked = tkern.flash_attention_bwd_plain(*tx[:3], o, lse, tx[3], **mask)
    for a, b in zip(whole, blocked):
        assert float((a - b).abs().max()) < 1e-5 * float(a.abs().max())


def test_bf16_gradients_come_back_in_bf16():
    (q, k, v, do), mask = _arrays("d120_window")
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k, v)]
    out = tkern.flash_attention(*leaves, **mask)
    grads = torch.autograd.grad(out, leaves,
                                torch.from_numpy(do).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for g in grads)


def test_bwd_wrapper_on_cpu_counts_no_launch():
    (q, k, v, do), mask = _arrays("gqa")
    tx = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = tkern.flash_attention_fwd(*tx[:3], **mask, return_lse=True)
    before = (tkern.flash_attention_bwd.launches,
              dict(tkern.flash_attention_bwd.pass_launches),
              dict(tkern.flash_attention_bwd.body_launches))
    got = tkern.flash_attention_bwd(*tx[:3], o, lse, tx[3], **mask)
    want = tkern.flash_attention_bwd_plain(*tx[:3], o, lse, tx[3], **mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tkern.flash_attention_bwd.launches,
            tkern.flash_attention_bwd.pass_launches,
            tkern.flash_attention_bwd.body_launches) == before
    assert set(before[1]) == set(tkern.BWD_PASSES) == {"dkdv", "dq"}


@pytest.mark.parametrize("d,dv,ok", [
    (64, 64, True), (80, 80, True), (120, 120, True), (128, 128, True),
    (192, 128, True), (16, 8, True), (200, 128, False), (192, 136, False),
    (0, 64, False), (64, 0, False)])
def test_bwd_width_check(d, dv, ok):
    """The zoo's training widths pass; wider ones raise (and never fall
    back to the plain version)."""
    if ok:
        tkern.check_bwd_widths(d, dv)
    else:
        with pytest.raises(ValueError, match="flash backward kernel"):
            tkern.check_bwd_widths(d, dv)


# ---------------------------------------------------------------------------
# The bf16 tensor-core body: its rounding emulated, its body rule and layout
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
TC_CASES = {   # b, s, t, h, hkv, d, dv, causal, window
    "d128_causal_gqa": (1, 256, 256, 4, 2, 128, 128, True, 0),
    "d192_dv128": (1, 256, 256, 2, 2, 192, 128, True, 0),
    "d120_window": (1, 320, 320, 4, 2, 120, 120, True, 96),
    "noncausal_s_ne_t": (2, 96, 160, 4, 1, 64, 64, False, 0),
}
TC_BAR = 5e-3   # chip_smoke.py phase S's bf16 bar, of each output's max |ref|


def _bf16(x):
    """Round an f32 tensor to bf16 (nearest even), kept as f32."""
    return x.to(torch.bfloat16).float()


def _tc_bwd_numerics(q, k, v, o, lse, do, *, causal, window, split=True):
    """The arithmetic of ``flash_attention_bwd.cu``'s bf16 body in torch
    f32, one head at a time (rounding is per element; the kernel's tiles
    only reorder f32 sums): f32 scores of bf16-valued operands; P =
    exp2(S scale log2 e - lse log2 e) on the visible keys; D = rowsum(dO o)
    in f32; dS = P (dP - D); P into dV and dS into dK and dQ as bf16 halves
    hi = bf16(x) and lo = bf16(x - hi) (``split=False``: hi alone); f32
    sums; dq, dk, dv rounded to bf16 once.  q, k, v, o, do: f32 tensors
    holding bf16 values; lse f32 (B, H, S)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    sc = scale * torch.tensor(LOG2E, dtype=torch.float32)
    dsum = (do * o).sum(-1)
    ok = tkern._visible(0, s, t, causal, window, "cpu")
    dq, dk, dv = (torch.zeros(x.shape) for x in (q, k, v))

    def halves(x):
        hi = _bf16(x)
        return hi, (_bf16(x - hi) if split else torch.zeros_like(x))

    for bi in range(b):
        for hh in range(h):
            hk = hh // rep
            qh, kh, vh, doh = (q[bi, :, hh], k[bi, :, hk], v[bi, :, hk],
                               do[bi, :, hh])
            p = torch.where(ok, torch.exp2(qh @ kh.T * sc
                                           - lse[bi, hh, :, None] * LOG2E),
                            0.0)
            ds = p * (doh @ vh.T - dsum[bi, :, hh, None])
            (p_hi, p_lo), (ds_hi, ds_lo) = halves(p), halves(ds)
            dv[bi, :, hk] += p_hi.T @ doh + p_lo.T @ doh
            dk[bi, :, hk] += ds_hi.T @ qh + ds_lo.T @ qh
            dq[bi, :, hh] = (ds_hi @ kh + ds_lo @ kh) * scale
    return _bf16(dq), _bf16(dk * scale), _bf16(dv)


def _tc_inputs(name):
    """bf16-valued q, k, v, dO (f32) and the plain bf16 forward's o, lse."""
    b, s, t, h, hkv, d, dv, causal, win = TC_CASES[name]
    g = torch.Generator().manual_seed(sorted(TC_CASES).index(name))
    xs = [_bf16(torch.randn(sh, generator=g)) for sh in
          ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, dv), (b, s, h, dv))]
    mask = dict(causal=causal, window=win)
    o, lse = tkern.flash_attention_plain(
        *(x.to(torch.bfloat16) for x in xs[:3]), **mask, return_lse=True)
    return xs, o, lse, mask


def _plain_bf16(xs, o, lse, mask):
    q, k, v, do = (x.to(torch.bfloat16) for x in xs)
    return tkern.flash_attention_bwd_plain(q, k, v, o, lse, do, **mask)


def _tc_errs(name, split=True):
    xs, o, lse, mask = _tc_inputs(name)
    got = _tc_bwd_numerics(*xs[:3], o.float(), lse, xs[3], **mask,
                           split=split)
    want = _plain_bf16(xs, o, lse, mask)
    return {n: _rel(g.numpy(), w.float().numpy())
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("name", list(TC_CASES))
def test_tc_bwd_numerics_hold_phase_s_bar(name):
    """The emulated body against ``flash_attention_bwd_plain`` in bf16 on
    the plain forward's o and lse (phase S's comparison): d = 128 causal
    GQA, d = 192 / dv = 128, d = 120 with a window (the padded k-step),
    non-causal S != T."""
    errs = _tc_errs(name)
    assert max(errs.values()) < TC_BAR, errs


def test_tc_bwd_numerics_match_jax_chunked_attention():
    """The emulated body against ``jax.vjp`` of the reference's
    ``chunked_attention`` (causal, f32 on the same bf16-valued inputs) at
    d = 128 with GQA."""
    xs, o, lse, mask = _tc_inputs("d128_causal_gqa")
    q, k, v, do = (x.numpy() for x in xs)
    pos = jnp.asarray(np.broadcast_to(np.arange(q.shape[1], dtype=np.int32),
                                      q.shape[:2]))
    _, vjp = jax.vjp(lambda a, b_, c: chunked_attention(a, b_, c, pos, pos,
                                                        kv_chunk=64),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _tc_bwd_numerics(*xs[:3], o.float(), lse, xs[3], **mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g.numpy(), np.asarray(w)) < TC_BAR, (name, _rel(
            g.numpy(), np.asarray(w)))


@pytest.mark.parametrize("name", ["d192_dv128", "d120_window"])
def test_split_halves_lower_the_rounding_error(name):
    """Why the body multiplies by the hi and lo bf16 halves of P and dS:
    with hi alone every output's error against the plain version is 2-8
    times as large (3.5e-3 to 4.8e-3 of max |ref| here; 5.7e-3, over phase
    S's bar, for dv at d = 128); the halves at least divide it by 1.5."""
    split, alone = _tc_errs(name), _tc_errs(name, split=False)
    assert max(split.values()) < TC_BAR, split
    assert all(split[n] < alone[n] / 1.5 for n in ("dq", "dk", "dv")), (
        split, alone)


def test_bwd_body_by_dtype_and_width():
    """The backward's body rule: bf16 on the 8-k-step tensor-core body up
    to d = 128 (h2o's 120 on a zeroed pad chunk), the 12-k-step one above
    (MLA's 192 / 128); f32 on the CUDA cores."""
    bf16 = torch.bfloat16
    for d, dv in ((64, 64), (80, 80), (120, 120), (128, 128), (32, 24)):
        assert tkern.fa_bwd_body(bf16, d, dv) == "tc_k8"
    assert tkern.fa_bwd_body(bf16, 192, 128) == "tc_k12"
    assert tkern.fa_bwd_body(torch.float32, 128, 128) == "cuda_core"
    assert tkern.fa_bwd_body(torch.float32, 192, 128) == "cuda_core"
    assert (set(tkern.flash_attention_bwd.body_launches)
            == set(tkern.BWD_BODIES) == {"cuda_core", "tc_k8", "tc_k12"})


@pytest.mark.parametrize("bad", [None, "pointer", "stride"])
def test_bwd_layout_checks_do(bad):
    """The backward's checks hold dO to the bf16 layout too: a dO that
    starts off a 16-byte boundary, or whose strides are not multiples of 8
    elements, raises (never a fallback)."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = v = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    do = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    if bad == "pointer":
        do = torch.zeros((1, 8, 4, 72), dtype=torch.bfloat16)[..., 1:65]
    elif bad == "stride":
        do = torch.zeros((1, 8, 4, 68), dtype=torch.bfloat16)[..., :64]
    if bad is None:
        tkern.check_inputs(q, k, v, do)
        return
    tkern.check_inputs(q, k, v)
    with pytest.raises(ValueError, match="bf16 flash kernel"):
        tkern.check_inputs(q, k, v, do)
