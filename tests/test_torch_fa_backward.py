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
them against these plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import attention_ref
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
              dict(tkern.flash_attention_bwd.pass_launches))
    got = tkern.flash_attention_bwd(*tx[:3], o, lse, tx[3], **mask)
    want = tkern.flash_attention_bwd_plain(*tx[:3], o, lse, tx[3], **mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tkern.flash_attention_bwd.launches,
            tkern.flash_attention_bwd.pass_launches) == before
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
