"""The port's SSD chunk step and chunked SSD against the JAX package.

The JAX Pallas kernel runs in interpret mode, its default on the CPU
(``repro.kernels.ssd.ops``).  Both packages get the same numpy inputs on the
five sweep cases of ``tests/test_kernels_ssd.py``; bf16 cases cast the same
f32 draws to bf16 in both.  Tolerances, relative to each output's max |ref|:
2e-5 where both sides compute in f32 from the same inputs; 1e-2 for an
output rounded to bf16 (one bf16 ulp is 2^-8).  The CUDA kernel itself runs
only on the card, where ``chip_smoke.py`` holds it against
``ssd_chunks_plain``.  The module runs on one torch thread, as the other
port modules do: the sums of a GEMM may split by thread count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_chunks as j_ssd_chunks
from repro.kernels.ssd.ops import ssd_chunked_kernel as j_ssd_chunked_kernel
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import kernel as tkern
from repro_torch.kernels.ssd.ops import ssd_chunked_kernel
from repro_torch.models import ssm as tssm
from torch_one_thread import one_torch_thread  # noqa: F401

SWEEP = [
    # bs, s, h, p, g, n, chunk, dtype
    (2, 64, 4, 8, 2, 16, 16, "float32"),
    (1, 48, 2, 16, 1, 8, 16, "float32"),
    (1, 128, 8, 8, 1, 32, 32, "float32"),
    (2, 64, 4, 8, 4, 16, 16, "float32"),
    (1, 64, 4, 8, 2, 16, 16, "bfloat16"),
]


def _inputs(case):
    bs, s, h, p, g, n, chunk, dt = SWEEP[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(
        np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    b = (0.3 * rng.standard_normal((bs, s, g, n))).astype(np.float32)
    c = (0.3 * rng.standard_normal((bs, s, g, n))).astype(np.float32)
    dsk = np.ones(h, np.float32)
    jx = [jnp.asarray(v) for v in (x, dtv, a, b, c, dsk)]
    tx = [torch.from_numpy(v) for v in (x, dtv, a, b, c, dsk)]
    if dt == "bfloat16":
        for arrs, cast in ((jx, lambda v: v.astype(jnp.bfloat16)),
                           (tx, lambda v: v.to(torch.bfloat16))):
            for i in (0, 3, 4):
                arrs[i] = cast(arrs[i])
    return jx, tx, chunk, dt


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max())
                                              + 1e-30)


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_ssd_chunks_plain_matches_jax_kernel(case):
    (x, dtv, a, b, c, _), tx, chunk, _ = _inputs(case)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    br = jnp.repeat(b, h // g, axis=2).reshape(bs, nc, chunk, h, n)
    cr = jnp.repeat(c, h // g, axis=2).reshape(bs, nc, chunk, h, n)
    want = j_ssd_chunks(x.reshape(bs, nc, chunk, h, p),
                        dtv.reshape(bs, nc, chunk, h), a, br, cr,
                        chunk=chunk)
    got = tkern.ssd_chunks(*tx[:5], chunk=chunk)
    for name, gt, wt in zip(("y_intra", "states", "cum"), got, want):
        assert gt.dtype == torch.float32
        assert tuple(gt.shape) == wt.shape
        assert _rel(gt, wt) < 2e-5, (case, name, _rel(gt, wt))


@pytest.mark.parametrize("case", range(len(SWEEP)))
def test_ssd_chunked_kernel_matches_jax(case):
    jx, tx, chunk, dt = _inputs(case)
    want = j_ssd_chunked_kernel(*jx, chunk)
    got = ssd_chunked_kernel(*tx, chunk)
    assert got.dtype == tx[0].dtype
    tol = 2e-5 if dt == "float32" else 1e-2
    assert _rel(got, want) < tol, (case, _rel(got, want))


@pytest.mark.parametrize("case", [0, 2, 3])
def test_ssd_chunked_and_reference_match_jax(case):
    jx, tx, chunk, _ = _inputs(case)
    assert _rel(tssm.ssd_chunked(*tx, chunk),
                jssm.ssd_chunked(*jx, chunk)) < 2e-5
    want = jssm.ssd_reference(*jx)
    assert _rel(tssm.ssd_reference(*tx), want) < 2e-5
    # the kernel path against the per-step recurrence (the JAX suite's bar)
    assert _rel(ssd_chunked_kernel(*tx, chunk), want) < 2e-3


def test_wrapper_dispatch_on_cpu_counts_no_launch():
    _, tx, chunk, _ = _inputs(0)
    before = tkern.ssd_chunks.launches
    tkern.ssd_chunks(*tx[:5], chunk=chunk)
    assert tkern.ssd_chunks.launches == before
    with pytest.raises(ValueError, match="multiple of chunk"):
        tkern.ssd_chunks(*tx[:5], chunk=24)


def test_strided_views_match_contiguous():
    """The prefill path hands the kernel strided views of the conv output;
    the plain version must give the same answer as for contiguous copies."""
    bs, s, h, p, g, n, chunk = 2, 32, 4, 8, 1, 8, 16
    rng = np.random.default_rng(3)
    xbc = torch.from_numpy(rng.standard_normal(
        (bs, s, h * p + 2 * g * n)).astype(np.float32))
    x = xbc[..., :h * p].view(bs, s, h, p)
    b = xbc[..., h * p:h * p + g * n].view(bs, s, g, n)
    c = xbc[..., h * p + g * n:].view(bs, s, g, n)
    dtv = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((bs, s, h)).astype(np.float32)))
    a = -torch.linspace(1.0, 4.0, h)
    got = tkern.ssd_chunks(x, dtv, a, b, c, chunk=chunk)
    want = tkern.ssd_chunks(x.contiguous(), dtv, a, b.contiguous(),
                            c.contiguous(), chunk=chunk)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)


ALIGNED = ([0, 4096, 8192], [8, 64])


@pytest.mark.parametrize("chunk, p, n, layout, ok", [
    (128, 64, 64, ALIGNED, True),      # Zamba2-2.7B
    (128, 64, 128, ALIGNED, True),     # Mamba-2-2.7B
    (16, 8, 16, ALIGNED, True),        # the sweeps' shapes
    (16, 16, 8, ALIGNED, True),
    (32, 8, 32, ALIGNED, True),
    (64, 24, 40, ALIGNED, True),
    (24, 64, 64, ALIGNED, False),      # chunk % 16
    (256, 64, 64, ALIGNED, False),     # chunk > 128
    (128, 64, 12, ALIGNED, False),     # N % 8
    (128, 4, 64, ALIGNED, False),      # P % 8
    (128, 64, 256, ALIGNED, False),    # N > 128
    (128, 64, 64, ([0, 4104, 8192], [8, 64]), False),   # b 8 bytes off 16
    (128, 64, 64, ([0, 4096, 8192], [8, 68]), False),   # stride % 8
])
def test_tc_takes(chunk, p, n, layout, ok):
    """The shapes and layouts the tensor-core body takes."""
    assert tkern.tc_takes(chunk, p, n, *layout) is ok


def test_body_choice_and_rejection():
    """bf16 at a shape and layout the tensor-core body takes chooses it;
    f32, and bf16 at an odd offset, choose the CUDA-core body; asking for
    ``"tc"`` where it does not apply raises on any device."""
    _, tx, chunk, _ = _inputs(4)                     # the bf16 sweep case
    x, dtv, a, b, c = tx[:5]
    assert tkern.ssd_body(x, b, c, chunk) == "tc"
    assert tkern.ssd_body(x.float(), b.float(), c.float(), chunk) == \
        "cuda_core"
    base = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    x_odd = base[1:].view(x.shape)                   # 2 bytes off 16
    assert tkern.ssd_body(x_odd, b, c, chunk) == "cuda_core"
    assert set(tkern.ssd_chunks.body_launches) == set(tkern.BODIES)
    want = tkern.ssd_chunks(x, dtv, a, b, c, chunk=chunk)
    for body in tkern.BODIES:
        got = tkern.ssd_chunks(x, dtv, a, b, c, chunk=chunk, body=body)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    for xx, body in ((x.float(), "tc"), (x_odd, "tc"), (x, "wgmma")):
        with pytest.raises(ValueError, match="no '"):
            tkern.ssd_chunks(xx, dtv, a, b.to(xx.dtype), c.to(xx.dtype),
                             chunk=chunk, body=body)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _tc_numerics(x, dt, a, b, c, split):
    """The tensor-core body's arithmetic for one chunk of one head: x (L,P),
    dt (L,), a scalar, b/c (L,N), all bf16-valued.  S = C B^T with exact
    bf16 products summed in f32; W masked before the exponential, in f32;
    W and B o dte rounded to bf16 as hi (+ lo = bf16(v - hi) with
    ``split``); products against x summed in f32 (here f64)."""
    L = x.shape[0]
    cum = np.cumsum(dt * a, dtype=np.float32)
    s = (c.astype(np.float64) @ b.astype(np.float64).T).astype(np.float32)
    li = np.tril(np.ones((L, L), bool))
    seg = np.where(li, cum[:, None] - cum[None, :], -np.inf)
    w = np.where(li, s * np.exp(seg.astype(np.float32)) * dt[None, :],
                 0).astype(np.float32)
    bd = (b * (np.exp(cum[-1] - cum) * dt)[:, None]).astype(np.float32)
    y, st = 0.0, 0.0
    for part in (w, bd):
        hi = _bf16(part)
        halves = (hi, _bf16(part - hi)) if split else (hi,)
        for half in halves:
            if part is w:
                y = y + half.astype(np.float64) @ x
            else:
                st = st + half.T.astype(np.float64) @ x
    return y, st


def test_tc_split_keeps_w_and_b_dte_to_16_bits():
    """Why the tensor-core body multiplies x by both bf16 halves of W and
    of B o dte: at one Zamba2 chunk (L = 128, N = P = 64, 8 heads, inputs
    drawn as chip_smoke.py draws the prefill's), the emulated body with the
    split is ~5e-6 of max |ref| from ssd_chunks_plain, 100x inside the
    kernel's 5e-4 bar; with the hi halves alone it reads ~2.5e-3, 5x over
    the bar."""
    rng = np.random.default_rng(0)
    L, P, N, H = 128, 64, 64, 8
    x = _bf16(rng.standard_normal((1, L, H, P)))
    b, c = (_bf16(rng.standard_normal((1, L, 1, N))) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((1, L, H)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, H).astype(np.float32)
    want = tkern.ssd_chunks_plain(
        *(torch.from_numpy(v) for v in (x, dt, a, b, c)), chunk=L)
    wy, ws = want[0][0, 0].numpy(), want[1][0, 0].numpy()
    err = {}
    for split in (True, False):
        ey = es = 0.0
        for h in range(H):
            y, st = _tc_numerics(x[0, :, h], dt[0, :, h], a[h], b[0, :, 0],
                                 c[0, :, 0], split)
            ey = max(ey, float(np.abs(y - wy[:, h]).max()))
            es = max(es, float(np.abs(st - ws[h]).max()))
        err[split] = max(ey / float(np.abs(wy).max()),
                         es / float(np.abs(ws).max()))
    assert err[True] < 5e-4 / 10, err
    assert err[False] > 5e-4, err
