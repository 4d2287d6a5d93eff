"""The port's SSD backward: the plain gradient written out, the autograd
Function the models train through, the wrapper's dispatch and the
roofline's work count.

``ssd_chunks_bwd_plain`` is held against ``torch.autograd.grad`` through
``ssd_chunks_plain`` at f64 (1e-10 of each gradient's max |ref|) on the
five sweep cases of ``tests/test_kernels_ssd.py``, with random cotangents
on all three outputs (y_intra, states and cum: a dropped or misfolded
``cum`` gradient is exact at one chunk and wrong at two, so every case
holds two or more).  Then the Function, through ``ssd_chunked_kernel``,
against ``jax.vjp`` of the reference's ``repro.models.ssm.ssd_chunked`` on
the same numpy inputs: f32 within 1e-4 of max |ref| for dx, d(dt), da, db
and dc; the bf16 case within the forward sweep's 1e-2 (the reference sums
in bf16, the port in f32, and both round the gradients to bf16).  The CUDA
kernel itself runs only on the card, where ``chip_smoke.py`` (phase U)
holds it against ``ssd_chunks_bwd_plain``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd import kernel as tkern
from repro_torch.kernels.ssd.ops import ssd_chunked_kernel
from repro_torch.launch import roofline
from torch_one_thread import one_torch_thread  # noqa: F401

SWEEP = [
    # bs, s, h, p, g, n, chunk, dtype (the sweep of tests/test_kernels_ssd.py)
    (2, 64, 4, 8, 2, 16, 16, "float32"),
    (1, 48, 2, 16, 1, 8, 16, "float32"),
    (1, 128, 8, 8, 1, 32, 32, "float32"),     # G = 1, H = 8
    (2, 64, 4, 8, 4, 16, 16, "float32"),      # G = 4
    (1, 64, 4, 8, 2, 16, 16, "bfloat16"),
]
BAR = {"float32": 1e-4, "bfloat16": 1e-2}
NAMES = ("dx", "ddt", "da", "db", "dc")


def _draw(case, dtype=np.float32):
    bs, s, h, p, g, n, chunk, _ = SWEEP[case]
    rng = np.random.default_rng(100 + case)
    x = rng.standard_normal((bs, s, h, p))
    dtv = np.log1p(np.exp(rng.standard_normal((bs, s, h))))
    a = -np.exp(0.5 * rng.standard_normal(h))
    b = 0.3 * rng.standard_normal((bs, s, g, n))
    c = 0.3 * rng.standard_normal((bs, s, g, n))
    return [v.astype(dtype) for v in (x, dtv, a, b, c)], chunk, rng


def _rel(got, want):
    got = np.asarray(got.double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-300)


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_plain_backward_matches_autograd_f64(case):
    arrs, chunk, rng = _draw(case, np.float64)
    ins = [torch.from_numpy(v).requires_grad_(True) for v in arrs]
    outs = tkern.ssd_chunks_plain(*ins, chunk=chunk)
    cts = [torch.from_numpy(rng.standard_normal(tuple(o.shape)))
           for o in outs]
    want = torch.autograd.grad(outs, ins, cts)
    got = tkern.ssd_chunks_bwd_plain(*(t.detach() for t in ins),
                                     outs[2].detach(), *cts, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert _rel(g, w.numpy()) < 1e-10, (case, name, _rel(g, w.numpy()))


def test_plain_backward_without_the_cum_gradient_is_wrong():
    """The incoming gradient of ``cum`` matters at two chunks: dropping it
    moves d(dt) and da far outside the bar."""
    arrs, chunk, rng = _draw(0, np.float64)
    ins = [torch.from_numpy(v) for v in arrs]
    outs = tkern.ssd_chunks_plain(*ins, chunk=chunk)
    cts = [torch.from_numpy(rng.standard_normal(tuple(o.shape)))
           for o in outs]
    full = tkern.ssd_chunks_bwd_plain(*ins, outs[2], *cts, chunk=chunk)
    cut = tkern.ssd_chunks_bwd_plain(*ins, outs[2], *cts[:2],
                                     torch.zeros_like(cts[2]), chunk=chunk)
    assert _rel(cut[1], full[1].numpy()) > 1e-2
    assert _rel(cut[2], full[2].numpy()) > 1e-2
    for i in (0, 3, 4):                       # dx, db, dc do not read it
        assert torch.equal(cut[i], full[i])


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_function_matches_jax_vjp(case):
    """The Function through ``ssd_chunked_kernel`` (the plain versions on
    CPU tensors) against ``jax.vjp`` of the reference's jnp
    ``ssd_chunked``, the same numpy inputs and cotangent."""
    dtype = SWEEP[case][7]
    arrs, chunk, rng = _draw(case)
    dsk = np.ones(arrs[0].shape[2], np.float32)
    ct = rng.standard_normal(arrs[0].shape).astype(np.float32)
    jx = [jnp.asarray(v) for v in arrs]
    tx = [torch.from_numpy(v) for v in arrs]
    jct, tct = jnp.asarray(ct), torch.from_numpy(ct)
    if dtype == "bfloat16":
        for i in (0, 3, 4):
            jx[i] = jx[i].astype(jnp.bfloat16)
            tx[i] = tx[i].to(torch.bfloat16)
        jct, tct = jct.astype(jnp.bfloat16), tct.to(torch.bfloat16)
    _, vjp = jax.vjp(lambda *v: jssm.ssd_chunked(*v, jnp.asarray(dsk),
                                                 chunk), *jx)
    want = vjp(jct)
    tx = [t.requires_grad_(True) for t in tx]
    y = ssd_chunked_kernel(*tx, torch.from_numpy(dsk), chunk)
    got = torch.autograd.grad(y, tx, tct)
    for name, g, w, t in zip(NAMES, got, want, tx):
        assert g.dtype == t.dtype and tuple(g.shape) == w.shape
        err = _rel(g, np.asarray(w, np.float32))
        assert err < BAR[dtype], (case, name, err)


def test_function_runs_one_forward_and_one_backward(monkeypatch):
    """``ssd_chunk_step`` takes the Function only when autograd records and
    an input needs a gradient; its backward calls ``ssd_chunks_bwd`` once
    with the saved ``cum`` and the three outputs' gradients."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tkern.ssd_chunks, tkern.ssd_chunks_bwd

    def fwd(*args, **kw):
        calls["fwd"] += 1
        return real_fwd(*args, **kw)

    def bwd(*args, **kw):
        calls["bwd"] += 1
        assert all(t.is_contiguous() for t in args[5:])
        return real_bwd(*args, **kw)
    monkeypatch.setattr(tkern, "ssd_chunks", fwd)
    monkeypatch.setattr(tkern, "ssd_chunks_bwd", bwd)
    arrs, chunk, _ = _draw(3)
    tx = [torch.from_numpy(v) for v in arrs]
    with torch.no_grad():
        tkern.ssd_chunk_step(*tx, chunk=chunk)
    tkern.ssd_chunk_step(*tx, chunk=chunk)           # no input needs one
    assert calls == {"fwd": 2, "bwd": 0}
    tx[3].requires_grad_(True)
    y, st, cum = tkern.ssd_chunk_step(*tx, chunk=chunk)
    (y.sum() + st.sum() + cum.sum()).backward()
    assert calls == {"fwd": 3, "bwd": 1}
    assert tx[3].grad is not None and tx[3].grad.shape == tx[3].shape


def test_wrapper_dispatch_on_cpu_counts_no_launch():
    arrs, chunk, rng = _draw(0)
    tx = [torch.from_numpy(v) for v in arrs]
    outs = tkern.ssd_chunks(*tx, chunk=chunk)
    cts = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
        np.float32)) for o in outs]
    before = tkern.ssd_chunks_bwd.launches
    got = tkern.ssd_chunks_bwd(*tx, outs[2], *cts, chunk=chunk)
    want = tkern.ssd_chunks_bwd_plain(*tx, outs[2], *cts, chunk=chunk)
    assert tkern.ssd_chunks_bwd.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    f32 = tkern.ssd_chunks_bwd(*tx, outs[2], *cts, chunk=chunk, cast=False)
    assert all(g.dtype == torch.float32 for g in f32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tkern.ssd_chunks_bwd(*tx, outs[2], *cts, chunk=24)


def _bwd_args(dtype=torch.float32, **over):
    """Valid backward inputs at a small shape (2 chunks of 16), with
    ``over`` replacing some."""
    bs, s, h, p, g, n, L = 1, 32, 4, 8, 2, 16, 16
    nc = s // L
    args = dict(
        x=torch.zeros((bs, s, h, p), dtype=dtype),
        dt=torch.ones((bs, s, h)), a=-torch.ones(h),
        b=torch.zeros((bs, s, g, n), dtype=dtype),
        c=torch.zeros((bs, s, g, n), dtype=dtype),
        cum=torch.zeros((bs, nc, L, h)), dy=torch.zeros((bs, nc, L, h, p)),
        dst=torch.zeros((bs, nc, h, n, p)), dcum=torch.zeros((bs, nc, L, h)))
    args.update(over)
    return args, L


@pytest.mark.parametrize("bad, match", [
    ({"dy": torch.zeros((1, 2, 16, 4, 8), dtype=torch.bfloat16)}, "dy"),
    ({"dst": torch.zeros((1, 2, 4, 8, 16)).transpose(3, 4)}, "dst"),
    ({"cum": torch.zeros((1, 2, 16, 3))}, "cum"),
    ({"dcum": torch.zeros((1, 2, 16, 4), dtype=torch.float64)}, "dcum"),
    ({"x": torch.zeros((1, 32, 8, 4)).transpose(2, 3)}, "contiguous"),
    ({"dt": torch.ones((1, 32, 4), dtype=torch.float64)}, "float32"),
])
def test_backward_refuses_what_the_kernel_does_not_take(bad, match):
    """The checks a CUDA call runs before launching (here on CPU tensors,
    the kernel's rules being device-independent)."""
    args, L = _bwd_args(**bad)
    with pytest.raises((ValueError, TypeError), match=match):
        tkern.check_bwd_inputs(*args.values(), chunk=L)


def test_backward_refuses_a_block_beyond_shared_memory():
    """Mamba-2's chunk (L 128, P 64, N 128) fits with padded rows; a chunk
    of 256 does not fit at all and raises before any launch."""
    assert tkern.bwd_smem_bytes(128, 64, 128, pad=4) <= tkern.SMEM_MAX
    assert tkern.bwd_smem_bytes(256, 64, 64) > tkern.SMEM_MAX
    bs, s, h, p, g, n, L = 1, 256, 2, 64, 1, 64, 256
    args, _ = _bwd_args(
        x=torch.zeros((bs, s, h, p)), dt=torch.ones((bs, s, h)),
        a=-torch.ones(h), b=torch.zeros((bs, s, g, n)),
        c=torch.zeros((bs, s, g, n)), cum=torch.zeros((bs, 1, L, h)),
        dy=torch.zeros((bs, 1, L, h, p)), dst=torch.zeros((bs, 1, h, n, p)),
        dcum=torch.zeros((bs, 1, L, h)))
    tkern.check_inputs(*list(args.values())[:5])
    with pytest.raises(ValueError, match="shared memory"):
        tkern.check_bwd_inputs(*args.values(), chunk=L)


def test_ssd_work_by_hand():
    """``ssd_fwd_work`` / ``ssd_bwd_work`` at B 1, S 8, H 2, P 3, G 1, N 2,
    chunk 4 (NC 2, T = 10 causal pairs), x, b, c bf16; counted by hand."""
    bf, f = torch.bfloat16, torch.float32
    x = torch.empty((1, 8, 2, 3), dtype=bf, device="meta")
    dt = torch.empty((1, 8, 2), dtype=f, device="meta")
    a = torch.empty((2,), dtype=f, device="meta")
    b = torch.empty((1, 8, 1, 2), dtype=bf, device="meta")
    c = torch.empty((1, 8, 1, 2), dtype=bf, device="meta")
    cum = torch.empty((1, 2, 4, 2), dtype=f, device="meta")
    dy = torch.empty((1, 2, 4, 2, 3), dtype=f, device="meta")
    dst = torch.empty((1, 2, 2, 2, 3), dtype=f, device="meta")
    ins = 48 * 2 + 16 * 4 + 2 * 4 + 16 * 2 + 16 * 2       # 232 bytes
    outs = 4 * (48 + 24 + 16)                               # y, st, cum
    assert roofline.ssd_fwd_work(x, dt, a, b, c, chunk=4) == (
        ins + outs, 2.0 * 2 * 2 * (10 * 2 + 10 * 3 + 4 * 2 * 3))
    grads_in = 4 * (16 + 48 + 24 + 16)          # cum, dy, dst, dcum
    assert roofline.ssd_bwd_work(x, dt, a, b, c, cum, dy, dst, cum,
                                 chunk=4) == (
        ins + grads_in + ins,
        2.0 * 2 * 2 * (3 * 10 * 2 + 2 * 10 * 3 + 2 * 4 * 2 * 3))
