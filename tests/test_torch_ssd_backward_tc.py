"""The SSD backward's tensor-core body, on the CPU: its rounding, its body
rule and its shared-memory budget, and the fold of dB / dC over a group's
heads.

The body (``csrc/ssd_chunks_bwd.cu``, ``ssdb_tc``) runs only on the card,
where ``chip_smoke.py`` (phase U) holds it against ``ssd_chunks_bwd_plain``
at 5e-4 of max |ref|.  Here ``_tc_bwd_numerics`` emulates its arithmetic in
torch f32: x, B and C exact in bf16; dY, dS and the W~ / W / dS' tiles
formed from the f32 accumulators enter the products as bf16 halves hi =
bf16(v), lo = bf16(v - hi) (both halves against an exact operand; hi hi +
hi lo + lo hi where both are f32, W~^T dY); every sum in f32; dseg's
diagonal kept apart from the row and column sums and the state term of
m = L-1 left out; the reverse scan, the state term's sum and da in f64.
That emulation is held against the plain version at phase U's bf16 bar and
once, through the autograd Function, against ``jax.vjp`` of the
reference's ``ssd_chunked``; with the hi halves alone it misses the bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels.ssd import kernel as tkern
from repro_torch.kernels.ssd.ops import ssd_chunked_kernel
from torch_one_thread import one_torch_thread  # noqa: F401

BAR = 5e-4            # phase U's bf16 bar (chip_smoke.py:SSD_BWD_BAR)
NAMES = ("dx", "ddt", "da", "db", "dc")
CASES = [             # bs, s, h, p, g, n, chunk
    (1, 256, 4, 64, 1, 128, 128),     # Mamba-2's chunk and state width
    (1, 256, 4, 64, 2, 64, 128),      # Zamba2's, two groups
    (1, 256, 4, 64, 1, 64, 64),
    (1, 256, 4, 64, 2, 128, 64),
]


def _halves(v, split=True):
    hi = v.bfloat16().float()
    return (hi, (v - hi).bfloat16().float()) if split else (hi,)


def _prod(a, b, split=True):
    """a @ b with an f32 ``a`` as bf16 halves against an exact ``b``."""
    return sum(h @ b for h in _halves(a, split))


def _prod3(a, b, split=True):
    """a @ b with both operands f32: hi hi + hi lo + lo hi."""
    ah, bh = _halves(a, split), _halves(b, split)
    out = ah[0] @ bh[0]
    if split:
        out = out + ah[0] @ bh[1] + ah[1] @ bh[0]
    return out


def _tc_bwd_numerics(x, dt, a, b, c, cum, dy, dst, dcum, *, chunk,
                     split=True):
    """(dx, ddt, da, db, dc) in f32 as the tensor-core body rounds them
    (``split=False``: every f32 operand as its hi half alone)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    L, nc = chunk, s // chunk
    hg = torch.arange(h) // (h // g)
    t = lambda v: v.transpose(-1, -2)                       # noqa: E731
    xm = x.float().reshape(bs, nc, L, h, p).permute(0, 1, 3, 2, 4)
    bm = b.float().reshape(bs, nc, L, g, n)[:, :, :, hg].permute(0, 1, 3,
                                                                 2, 4)
    cm = c.float().reshape(bs, nc, L, g, n)[:, :, :, hg].permute(0, 1, 3,
                                                                 2, 4)
    dtv = dt.reshape(bs, nc, L, h).permute(0, 1, 3, 2)     # (b, c, h, L)
    cu = cum.permute(0, 1, 3, 2)
    dym = dy.permute(0, 1, 3, 2, 4)                         # (b, c, h, L, p)
    dcu = dcum.permute(0, 1, 3, 2)
    tril = torch.ones((L, L), dtype=torch.bool).tril()
    strict, eye = tril.tril(-1), torch.eye(L, dtype=torch.bool)
    seg = cu[..., :, None] - cu[..., None, :]               # l, m
    e = torch.exp(torch.where(tril, seg, -torch.inf))       # mask first
    dtm = dtv[..., None, :]
    wt = (cm @ t(bm)) * e                                   # W~ (l, m)
    dw = _prod(dym, t(xm), split)                           # dY X^T
    dsp = torch.where(tril, dw * e * dtm, 0.0)              # dS'
    dc = _prod(dsp, bm, split)
    off = _prod3(t(torch.where(strict, wt, 0.0)), dym, split)
    full = off + _prod3(t(torch.where(eye, wt, 0.0)), dym, split)
    bds = bm @ sum(_halves(dst, split))                     # B dS
    xds = xm @ t(sum(_halves(dst, split)))                  # X dS^T
    dec = torch.exp(cu[..., -1:] - cu)
    dte = dec * dtv
    dx = dtv[..., None] * full + dte[..., None] * bds
    db = _prod(t(dsp), cm, split) + dte[..., None] * xds
    colsum = (xm * off).sum(-1)
    q = (xm * full).sum(-1)
    gm = (xm * bds).sum(-1)
    wx = _prod(torch.where(strict, wt * dtm, 0.0), xm, split)
    rowsum = (sum(_halves(dym, split)) * wx).sum(-1)
    dacc = dcu + (rowsum - dtv * colsum)
    gd = gm * dec * dtv
    dacc = torch.cat([dacc[..., :-1] - gd[..., :-1],
                      dacc[..., -1:] + gd[..., :-1].double().sum(
                          -1, keepdim=True).float()], -1)
    run = torch.flip(torch.cumsum(torch.flip(dacc.double(), [-1]), -1),
                     [-1])
    ddt = q + gm * dec + a[:, None] * run.float()
    da = (run * dtv.double()).sum((0, 1, 3)).float()
    back = lambda v: v.permute(0, 1, 3, 2, 4).reshape(bs, s, h, -1)  # noqa
    fold = lambda v: tkern.fold_groups(back(v), g)          # noqa: E731
    return (back(dx), back(ddt[..., None])[..., 0], da, fold(db),
            fold(dc))


def _inputs(case, seed):
    """bf16 x, b, c and f32 dt, a and cotangents as chip_smoke.py's phase U
    draws them (``ssd_bwd_inputs``), ``cum`` from the plain forward."""
    bs, s, h, p, g, n, L = case
    gen = torch.Generator().manual_seed(seed)
    x = (0.5 * torch.randn((bs, s, h, p), generator=gen)).bfloat16()
    b = (0.5 * torch.randn((bs, s, g, n), generator=gen)).bfloat16()
    c = (0.5 * torch.randn((bs, s, g, n), generator=gen)).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((bs, s, h), generator=gen))
    a = -torch.linspace(1.0, 16.0, h)
    y, st, cum = tkern.ssd_chunks_plain(x, dt, a, b, c, chunk=L)
    grads = [torch.randn(v.shape, generator=gen) for v in (y, st, cum)]
    return (x, dt, a, b, c, cum, *grads), L


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("case", CASES)
def test_tc_numerics_match_the_plain_backward(case):
    """The emulated body within phase U's bf16 bar (5e-4 of max |ref|) of
    ``ssd_chunks_bwd_plain`` on the same bf16 inputs, every gradient."""
    args, L = _inputs(case, 0)
    got = _tc_bwd_numerics(*args, chunk=L)
    want = tkern.ssd_chunks_bwd_plain(*args, chunk=L, cast=False)
    for name, gv, wv in zip(NAMES, got, want):
        assert gv.shape == wv.shape, name
        assert _rel(gv, wv) < BAR, (case, name, _rel(gv, wv))


def test_hi_halves_alone_miss_the_bar():
    """Why every f32 operand enters as two bf16 halves: at Mamba-2's chunk
    the hi halves alone put some gradient past 5e-4 of its max |ref|,
    where the split stays ten times inside it."""
    args, L = _inputs(CASES[0], 1)
    want = tkern.ssd_chunks_bwd_plain(*args, chunk=L, cast=False)
    err = {split: max(_rel(gv, wv) for gv, wv in zip(
        _tc_bwd_numerics(*args, chunk=L, split=split), want))
        for split in (True, False)}
    assert err[True] < BAR / 10, err
    assert err[False] > BAR, err


def test_tc_numerics_through_the_function_match_jax_vjp(monkeypatch):
    """The autograd Function through ``ssd_chunked_kernel`` with its
    backward the emulated body, on bf16 x, b, c and a bf16 cotangent,
    against ``jax.vjp`` of the reference's jnp ``ssd_chunked`` in f32 on
    the same values: d(dt) and da (f32 leaves) within phase U's 5e-4,
    dx, db and dc (bf16 leaves, so rounded to bf16 at the end: 2^-9 of
    each value) within 5e-3 of max |ref|."""
    def tc_bwd(*args, chunk, cast=True):
        out = _tc_bwd_numerics(*args, chunk=chunk)
        return tkern._cast_grads(out, args[:5]) if cast else out
    monkeypatch.setattr(tkern, "ssd_chunks_bwd", tc_bwd)
    bs, s, h, p, g, n, L = 1, 128, 4, 64, 2, 64, 64
    rng = np.random.default_rng(7)
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).bfloat16()  # noqa
    x = bf(0.5 * rng.standard_normal((bs, s, h, p)))
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(np.float32)
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    b, c = (bf(0.5 * rng.standard_normal((bs, s, g, n))) for _ in range(2))
    ct = bf(rng.standard_normal((bs, s, h, p)))
    dsk = np.ones(h, np.float32)
    f32 = lambda v: jnp.asarray(v.float().numpy())          # noqa: E731
    _, vjp = jax.vjp(lambda *v: jssm.ssd_chunked(*v, jnp.asarray(dsk), L),
                     f32(x), jnp.asarray(dt), jnp.asarray(a), f32(b), f32(c))
    want = vjp(f32(ct))
    assert tkern.ssd_bwd_body(x, b, c, L) == "tc"
    tx = [v.requires_grad_(True) for v in
          (x, torch.from_numpy(dt), torch.from_numpy(a), b, c)]
    y = ssd_chunked_kernel(*tx, torch.from_numpy(dsk), L)
    got = torch.autograd.grad(y, tx, ct)
    for name, gv, wv, v in zip(NAMES, got, want, tx):
        assert gv.dtype == v.dtype and tuple(gv.shape) == wv.shape
        err = _rel(gv, torch.from_numpy(np.array(wv, np.float32)))
        bar = BAR if v.dtype == torch.float32 else 5e-3
        assert err < bar, (name, err)


def test_cluster_fold_in_rank_order():
    """dB / dC as the tc body leaves them: each cluster of K heads of a group
    summed in rank order (the kernel's DSMEM fold), then ``fold_groups``'
    one torch sum over the clusters.  Equal to the per-head sum within f32
    rounding, and bitwise across two calls."""
    bs, s, h, g, n = 2, 16, 80, 1, 128
    k = tkern.cluster_heads(h // g)
    assert k == 8
    gen = torch.Generator().manual_seed(3)
    per_head = torch.randn((bs, s, h, n), generator=gen)

    def fold():
        ranks = per_head.view(bs, s, h // k, k, n).unbind(3)
        part = torch.zeros((bs, s, h // k, n))
        for r in ranks:                   # rank 0, 1, ..., K - 1
            part = part + r
        return tkern.fold_groups(part, g)
    got, again = fold(), fold()
    assert got.shape == (bs, s, g, n)
    assert torch.equal(got, again)
    want = per_head.double().view(bs, s, g, h // g, n).sum(3)
    scale = per_head.abs().max().double() * h
    assert float((got.double() - want).abs().max() / scale) < 1e-6
    assert torch.equal(tkern.fold_groups(per_head, g),
                       per_head.view(bs, s, g, h // g, n).sum(3))


@pytest.mark.parametrize("rep, k", [(80, 8), (40, 8), (12, 6), (9, 3),
                                    (7, 7), (2, 2), (1, 1)])
def test_cluster_heads(rep, k):
    assert tkern.cluster_heads(rep) == k


def test_tc_bwd_smem_budget():
    """The tc body's block: x, dY's halves, B, C and dS's halves in bf16
    rows padded by 16 bytes, the parked f32 dB / dC over the same bytes,
    seven f32 vectors; Mamba-2 and Zamba2 fit one block an SM of the
    227 KB a block may use, and the guarded instantiation's L = N = P = 128
    does not fit."""
    mamba2 = 2 * (3 * 128 * 72 + 2 * 128 * 136 + 2 * 128 * 72) + 4 * 7 * 128
    assert tkern.bwd_smem_bytes(128, 64, 128, body="tc") == mamba2 == 165376
    zamba2 = 2 * (3 * 128 * 72 + 2 * 128 * 72 + 2 * 64 * 72) + 4 * 7 * 128
    assert tkern.bwd_smem_bytes(128, 64, 64, body="tc") == zamba2 == 114176
    assert 4 * 2 * 128 * 136 < mamba2        # the parked dB, dC fit over
    assert tkern.bwd_smem_bytes(128, 128, 128, body="tc") > tkern.SMEM_MAX
    assert tkern.tc_bwd_sizes(64, 128) == (8, 4)
    assert tkern.tc_bwd_sizes(64, 64) == (4, 4)
    assert tkern.tc_bwd_sizes(8, 16) == (8, 8)


def _xbc(dtype, s, h, p, g, n, offset=0):
    buf = torch.zeros((1, s, h * p + 2 * g * n + offset), dtype=dtype)
    x = buf[..., offset:offset + h * p].view(1, s, h, p)
    b = buf[..., offset + h * p:offset + h * p + g * n].view(1, s, g, n)
    c = buf[..., offset + h * p + g * n:].view(1, s, g, n)
    return x, b, c


@pytest.mark.parametrize("dtype, dims, offset, chunk, body", [
    (torch.bfloat16, (256, 80, 64, 1, 128), 0, 128, "tc"),      # mamba2
    (torch.bfloat16, (256, 80, 64, 1, 64), 0, 128, "tc"),       # zamba2
    (torch.bfloat16, (64, 4, 8, 2, 16), 0, 16, "tc"),           # guarded
    (torch.float32, (256, 80, 64, 1, 128), 0, 128, "cuda_core"),
    (torch.bfloat16, (256, 8, 64, 1, 128), 1, 128, "cuda_core"),  # 2 bytes
    (torch.bfloat16, (256, 8, 64, 1, 128), 0, 256, "cuda_core"),  # L > 128
    (torch.bfloat16, (256, 4, 128, 1, 128), 0, 128, "cuda_core"),  # budget
])
def test_ssd_bwd_body(dtype, dims, offset, chunk, body):
    """The one rule: bf16 the tensor-core body takes (tc_takes' shapes and
    layouts, and a block that fits), else the CUDA-core body."""
    x, b, c = _xbc(dtype, *dims, offset=offset)
    assert tkern.ssd_bwd_body(x, b, c, chunk) == body


def test_backward_refuses_where_neither_body_fits():
    """L = N = P = 128 in bf16: the tc block does not fit, nor does the
    CUDA-core one, so the checks raise before any launch."""
    bs, s, h, p, g, n, L = 1, 128, 4, 128, 1, 128, 128
    x, b, c = _xbc(torch.bfloat16, s, h, p, g, n)
    args = (x, torch.ones((bs, s, h)), -torch.ones(h), b, c,
            torch.zeros((bs, 1, L, h)), torch.zeros((bs, 1, L, h, p)),
            torch.zeros((bs, 1, h, n, p)), torch.zeros((bs, 1, L, h)))
    assert tkern.ssd_bwd_body(x, b, c, L) == "cuda_core"
    with pytest.raises(ValueError, match="shared memory"):
        tkern.check_bwd_inputs(*args, chunk=L)


def test_bwd_bodies_are_counted_apart():
    assert set(tkern.ssd_chunks_bwd.body_launches) == set(tkern.BWD_BODIES)
    assert tkern.BWD_BODIES == ("tc", "cuda_core")
