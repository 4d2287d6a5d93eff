"""Mamba-2 SSD chunk step: the hand-written Hopper kernel and its plain
PyTorch version (port of ``repro.kernels.ssd.kernel.ssd_chunks``).

``ssd_chunks`` dispatches on the device of its tensors: a CPU tensor goes to
``ssd_chunks_plain``; a CUDA tensor launches ``csrc/ssd_chunks.cu`` on the
current stream, or raises; a ``meta`` tensor (the dry run's shape-only
route) also goes to the plain version, which gives the shapes and whose
products the cost counter counts.  No other device is accepted.  The kernel has two bodies: ``"tc"`` (bf16 on
the tensor cores, for the shapes and layouts of :func:`tc_takes`) and
``"cuda_core"`` (f32 products on the CUDA cores, any f32 or bf16 input
whose tile fits in shared memory).  :func:`ssd_body` picks one from the
dtype, shape and layout, never from a failed build or launch.  It counts
its launches in ``ssd_chunks.launches`` and, per body, in
``ssd_chunks.body_launches``.

Unlike the reference, both take B and C per group, (B, S, G, N): head h
reads group h // (H/G), so nothing is repeated over heads.  x may be a
strided view (the projection split) as long as each row's (H, P) block is
contiguous; B and C likewise with their (G, N) block.

The gradient: ``ssd_chunks_bwd`` (``csrc/ssd_chunks_bwd.cu``,
deterministic) with its plain version ``ssd_chunks_bwd_plain``, dispatched
the same way and counted in ``ssd_chunks_bwd.launches`` and, per body, in
``ssd_chunks_bwd.body_launches``.  Its two bodies: ``"tc"`` (bf16 on the
tensor cores, f32 operands as bf16 hi + lo halves, dB and dC summed over a
cluster of a group's heads inside the kernel) for the bf16 inputs
:func:`ssd_bwd_body` gives it, and ``"cuda_core"`` (f32 products, per-head
dB / dC partials) for f32 and the other bf16.  The reference has no SSD
backward kernel (it differentiates its jnp ``ssd_chunked``).
:func:`ssd_chunk_step` is what the models call: the forward kernel alone
when no input needs a gradient, else the autograd Function whose backward
runs ``ssd_chunks_bwd``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 8 + [_I] * 7 + [_L] * 6 + [_P]
SMEM_MAX = 232448
BODIES = ("tc", "cuda_core")
TC_MAX = 128          # the tensor-core body's bound on chunk, N and P
PLAIN_DEVICES = ("cpu", "meta")   # devices whose tensors take the plain route


def _work_dtype(*tensors):
    """f32 for f32 / bf16 inputs; f64 when one is f64 (the plain versions'
    f64 mode, which the CPU tests hold against autograd)."""
    wd = torch.float32
    for t in tensors:
        wd = torch.promote_types(wd, t.dtype)
    return wd


def ssd_chunks_plain(x, dt, a, b, c, *, chunk: int):
    """The per-chunk einsums of the reference kernel, vectorised over
    (B, NC).  x (B,S,H,P), dt (B,S,H) f32, a (H,) f32, b/c (B,S,G,N) ->
    (y_intra (B,NC,L,H,P), states (B,NC,H,N,P), cum (B,NC,L,H)), all f32
    (f64 for f64 inputs)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, nc, L = h // g, s // chunk, chunk
    wd = _work_dtype(x, dt, a, b, c)
    xr = x.to(wd).reshape(bs, nc, L, g, rep, p)
    dtr = dt.to(wd).reshape(bs, nc, L, g, rep)
    br = b.to(wd).reshape(bs, nc, L, g, n)
    cr = c.to(wd).reshape(bs, nc, L, g, n)

    # each chunk's running sum of the f32 steps dt * a taken in f64 and
    # rounded once, as the kernel's scan does: the same bits in any order
    # while the f64 sums are exact (over a chunk |cum| reaches ~1,400,
    # where an f32 running sum drifts by ~1e-4 and e^{cum_l - cum_m} with
    # it, in an order each implementation picks)
    cum = torch.cumsum((dtr * a.to(wd).reshape(g, rep)).double(),
                       dim=2).to(wd)
    seg = cum[:, :, :, None] - cum[:, :, None, :]       # (B,NC,L,L,G,R)
    li = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # mask before the exponential: masked entries would overflow to inf
    seg = torch.where(li[:, :, None, None], seg, -1e30)
    cb = torch.einsum("bclgn,bcmgn->bclmg", cr, br)
    w = cb[..., None] * torch.exp(seg) * dtr[:, :, None]
    y = torch.einsum("bclmgr,bcmgrp->bclgrp", w, xr)

    dte = torch.exp(cum[:, :, -1:] - cum) * dtr           # (B,NC,L,G,R)
    st = torch.einsum("bclgr,bclgn,bclgrp->bcgrnp", dte, br, xr)
    return (y.reshape(bs, nc, L, h, p), st.reshape(bs, nc, h, n, p),
            cum.reshape(bs, nc, L, h))


def ssd_chunks_bwd_plain(x, dt, a, b, c, cum, dy, dst, dcum, *, chunk: int,
                         cast: bool = True):
    """The gradient of :func:`ssd_chunks_plain` written out, vectorised over
    (B, NC): ``dy`` (B,NC,L,H,P), ``dst`` (B,NC,H,N,P) and ``dcum``
    (B,NC,L,H) are the gradients of its three outputs, ``cum`` its third
    output.  Returns (dx, ddt, da, db, dc) in their inputs' dtypes, every
    sum taken in f32 or wider (f64 for f64 inputs).  Per (batch, chunk,
    head), with W_lm = (c_l . b_m) e^{cum_l - cum_m} dt_m on m <= l and
    dte_m = e^{cum_{L-1} - cum_m} dt_m:

    * dX = W^T dY + diag(dte) B dS;  dW = dY X^T;  dS' = dW o E o dt_m;
      dC = dS' B;  dB = dS'^T C + diag(dte) X dS^T;
    * d(dt) from W (sum_l dW o C B^T o E), from dte, and a times the
      reverse cumulative sum of dcum;
    * dseg = dW o W adds to dcum by rows and subtracts by columns, the
      state adds sum_m G_m dte_m to dcum_{L-1} and subtracts G_m dte_m
      from dcum_m (G_m = sum_{n,p} b_mn x_mp dS_np), the incoming ``dcum``
      adds; d(dt a)_j = sum_{l >= j} dcum_l.  Terms that cancel exactly
      (dseg's diagonal, the state term of m = L-1) are left out, and the
      state term's sum, the reverse scan and da run in f64, as in the
      kernel.

    dB and dC are summed over the heads of each group, da over (B, NC, L).
    ``cast=False`` returns every gradient in the working dtype instead.
    """
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, nc, L = h // g, s // chunk, chunk
    wd = _work_dtype(x, dt, a, b, c)
    xr = x.to(wd).reshape(bs, nc, L, g, rep, p)
    dtr = dt.to(wd).reshape(bs, nc, L, g, rep)
    br = b.to(wd).reshape(bs, nc, L, g, n)
    cr = c.to(wd).reshape(bs, nc, L, g, n)
    cumr = cum.to(wd).reshape(bs, nc, L, g, rep)
    dyr = dy.to(wd).reshape(bs, nc, L, g, rep, p)
    dstr = dst.to(wd).reshape(bs, nc, g, rep, n, p)
    dcumr = dcum.to(wd).reshape(bs, nc, L, g, rep)

    seg = cumr[:, :, :, None] - cumr[:, :, None, :]     # (B,NC,L,L,G,R)
    li = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    lim = li[:, :, None, None]
    e = torch.exp(torch.where(lim, seg, -1e30))          # 0 above the diagonal
    cb = torch.einsum("bclgn,bcmgn->bclmg", cr, br)[..., None]
    w = cb * e * dtr[:, :, None]
    dw = torch.where(lim, torch.einsum("bclgrp,bcmgrp->bclmgr", dyr, xr),
                     0.0)
    dsc = dw * e * dtr[:, :, None]                       # d(c_l . b_m)
    dx = torch.einsum("bclmgr,bclgrp->bcmgrp", w, dyr)
    dc = torch.einsum("bclmgr,bcmgn->bclgn", dsc, br)
    db = torch.einsum("bclmgr,bclgn->bcmgn", dsc, cr)
    ddt = (dw * cb * e).sum(2)                           # over l
    strict = torch.ones((L, L), dtype=torch.bool,
                        device=x.device).tril(-1)[:, :, None, None]
    dseg = torch.where(strict, dw * w, 0.0)
    dcum_all = dcumr + dseg.sum(3) - dseg.sum(2)

    dec = torch.exp(cumr[:, :, -1:] - cumr)              # (B,NC,L,G,R)
    dte = dec * dtr
    dx = dx + torch.einsum("bclgr,bclgn,bcgrnp->bclgrp", dte, br, dstr)
    db = db + torch.einsum("bclgr,bclgrp,bcgrnp->bclgn", dte, xr, dstr)
    gm = torch.einsum("bclgn,bclgrp,bcgrnp->bclgr", br, xr, dstr)
    ddt = ddt + gm * dec
    gd = gm * dte
    dcum_all = torch.cat(
        [dcum_all[:, :, :-1] - gd[:, :, :-1],
         dcum_all[:, :, -1:] + gd[:, :, :-1].double().sum(
             2, keepdim=True).to(wd)], dim=2)
    rcum = torch.flip(torch.cumsum(torch.flip(dcum_all.double(), [2]), 2),
                      [2])
    ddt = ddt + rcum.to(wd) * a.to(wd).reshape(g, rep)
    da = (rcum * dtr.double()).sum((0, 1, 2)).reshape(h).to(wd)
    out = (dx.reshape(bs, s, h, p), ddt.reshape(bs, s, h), da,
           db.reshape(bs, s, g, n), dc.reshape(bs, s, g, n))
    return _cast_grads(out, (x, dt, a, b, c)) if cast else out


def _cast_grads(grads, inputs):
    return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def tc_takes(chunk: int, p: int, n: int, pointers, strides) -> bool:
    """Whether the tensor-core body takes these bf16 inputs: chunk % 16 == 0
    up to 128, N % 8 == 0 and P % 8 == 0 up to 128, 16-byte
    aligned base pointers (x, b, c) and batch / sequence strides that are
    multiples of 8 elements (its 16-byte copies)."""
    return (0 < chunk <= TC_MAX and chunk % 16 == 0
            and 0 < n <= TC_MAX and n % 8 == 0
            and 0 < p <= TC_MAX and p % 8 == 0
            and all(ptr % 16 == 0 for ptr in pointers)
            and all(st % 8 == 0 for st in strides))


def ssd_body(x, b, c, chunk: int) -> str:
    """The body for these inputs: ``"tc"`` for bf16 that
    :func:`tc_takes`, else ``"cuda_core"``."""
    ok = x.dtype == torch.bfloat16 and tc_takes(
        chunk, x.shape[3], b.shape[3],
        [t.data_ptr() for t in (x, b, c)],
        [t.stride(i) for t in (x, b, c) for i in (0, 1)])
    return "tc" if ok else "cuda_core"


def _entry(dtype, body: str):
    tag = "tc_" if body == "tc" else ""
    fn = getattr(_build.load("ssd_chunks"),
                 f"ssd_chunks_{tag}{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _smem_bytes(L: int, P: int, N: int) -> int:
    r4 = lambda v: -(-v // 4) * 4     # noqa: E731
    lp, pp, np_ = r4(L), r4(P), r4(N)
    return 4 * (2 * np_ * lp + lp * pp + lp * lp + 2 * lp)


def _check(x, dt, a, b, c):
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunks runs on CUDA, CPU or meta tensors, "
                         f"got {x.device}")
    check_inputs(x, dt, a, b, c)


def check_inputs(x, dt, a, b, c) -> None:
    """The kernels' rules on dtype, shape and layout, on any device: raise
    on what they do not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_chunks takes float32 or bfloat16, got "
                        f"{x.dtype}")
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("b and c must have x's dtype")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("dt and a must be float32")
    if tuple(dt.shape) != (bs, s, h) or not dt.is_contiguous():
        raise ValueError(f"dt must be contiguous {(bs, s, h)}")
    if tuple(a.shape) != (h,) or not a.is_contiguous():
        raise ValueError(f"a must be contiguous ({h},)")
    for name, t in (("b", b), ("c", c)):
        if tuple(t.shape) != (bs, s, g, n):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bs, s, g, n)}")
        if t.stride(3) != 1 or t.stride(2) != n:
            raise ValueError(f"{name}'s (G, N) block must be contiguous")
    if x.stride(3) != 1 or x.stride(2) != p:
        raise ValueError("x's (H, P) block must be contiguous")
    if g == 0 or h % g:
        raise ValueError(f"heads {h} must be a multiple of groups {g}")


def ssd_chunks(x, dt, a, b, c, *, chunk: int, body: str | None = None):
    """The SSD chunk step (see ``ssd_chunks_plain`` for the contract).
    ``body`` defaults to :func:`ssd_body`; ``"cuda_core"`` runs the
    CUDA-core body on any input it fits, ``"tc"`` raises for inputs the
    tensor-core body does not take (on any device: a CPU tensor runs the
    plain version whatever the body)."""
    if x.shape[1] % chunk:
        raise ValueError(f"sequence {x.shape[1]} is not a multiple of "
                         f"chunk {chunk}")
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    chosen = ssd_body(x, b, c, chunk)
    body = chosen if body is None else body
    if body not in BODIES or (body == "tc" and chosen != "tc"):
        raise ValueError(f"ssd_chunks has no {body!r} body for {x.dtype}, "
                         f"chunk {chunk}, P {p}, N {n} and this layout "
                         "(see tc_takes)")
    if x.device.type in PLAIN_DEVICES:
        return ssd_chunks_plain(x, dt, a, b, c, chunk=chunk)
    _check(x, dt, a, b, c)
    if body == "cuda_core" and _smem_bytes(chunk, p, n) > SMEM_MAX:
        raise ValueError(f"chunk {chunk}, P {p}, N {n} need more than "
                         f"{SMEM_MAX} bytes of shared memory")
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bs, nc, chunk, h, p), **f32)
    st = torch.empty((bs, nc, h, n, p), **f32)
    cum = torch.empty((bs, nc, chunk, h), **f32)
    if y.numel() == 0:
        return y, st, cum
    with torch.cuda.device(x.device):
        rc = _entry(x.dtype, body)(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), st.data_ptr(), cum.data_ptr(),
            bs, nc, chunk, h, p, g, n, x.stride(0), x.stride(1),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunks kernel launch failed with CUDA "
                           f"error {rc}")
    ssd_chunks.launches += 1
    ssd_chunks.body_launches[body] += 1
    return y, st, cum


ssd_chunks.launches = 0
ssd_chunks.body_launches = dict.fromkeys(BODIES, 0)


# ---------------------------------------------------------------------------
# the backward kernel (csrc/ssd_chunks_bwd.cu) and the autograd Function
# ---------------------------------------------------------------------------

_BWD_ARGTYPES = [_P] * 14 + [_I] * 7 + [_L] * 6 + [_P]
_BWD_TC_ARGTYPES = [_P] * 14 + [_I] * 9 + [_L] * 6 + [_P]
BWD_BODIES = ("tc", "cuda_core")
CLUSTER_MAX = 8       # heads a cluster of the tc backward sums dB, dC over


def _bwd_entry(dtype, body: str):
    if body == "tc":
        name, argtypes = "ssd_chunks_bwd_tc_bf16", _BWD_TC_ARGTYPES
    else:
        name, argtypes = f"ssd_chunks_bwd_{_DTYPES[dtype]}", _BWD_ARGTYPES
    fn = getattr(_build.load("ssd_chunks_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def cluster_heads(rep: int) -> int:
    """K, the heads of one group that a cluster of the tc backward sums dB
    and dC over: the largest divisor of the heads a group (``rep`` = H/G)
    up to ``CLUSTER_MAX`` (8 for Mamba-2's and Zamba2's 80)."""
    return max(k for k in range(1, min(rep, CLUSTER_MAX) + 1) if rep % k == 0)


def tc_bwd_sizes(p: int, n: int) -> tuple:
    """(NK, KP), the tc backward's instantiation for these widths: exact
    (8, 4) at N = 128, P = 64 (Mamba-2), (4, 4) at N = P = 64 (Zamba2),
    else the guarded (8, 8).  NK k-steps of 16 over N, KP over P; they fix
    the rows' strides in shared memory."""
    if (n, p) == (128, 64):
        return 8, 4
    if (n, p) == (64, 64):
        return 4, 4
    return 8, 8


def bwd_smem_bytes(L: int, P: int, N: int, pad: int = 0,
                   body: str = "cuda_core") -> int:
    """Shared memory of the backward kernel's block.  ``"cuda_core"`` (its
    rows padded by ``pad`` floats; the launcher takes 4 where that fits,
    else 0): the L x L tile region, two tile regions for B / C / x / dY,
    six per-step vectors and three per-step partial-sum tables.  ``"tc"``
    (csrc/ssd_chunks_bwd.cu:ssdb_tc::smem_bytes): x, dY's two bf16 halves,
    B, C and dS's two halves (N rounded up to 16 rows) in bf16 rows padded
    by 16 bytes, or, over the same bytes once the products are done, the
    parked f32 dB and dC tiles, whichever is more; then seven per-step f32
    vectors."""
    if body == "tc":
        nk, kp = tc_bwd_sizes(P, N)
        ldx, ldb = 16 * kp + 8, 16 * nk + 8
        nr = 16 * -(-N // 16)
        inputs = 2 * (3 * L * ldx + 2 * L * ldb + 2 * nr * ldx)
        return max(inputs, 4 * 2 * L * ldb) + 4 * 7 * L
    r4 = lambda v: -(-v // 4) * 4     # noqa: E731
    lp, pp, np_ = r4(L), r4(P), r4(N)
    ls, ps, ns = lp + pad, pp + pad, np_ + pad
    region_m = max(lp * ls, np_ * ps)
    region_1 = max(lp * ns, lp * ps)
    return 4 * (region_m + 2 * region_1 + 6 * lp + 3 * lp * (pp // 4))


def ssd_bwd_body(x, b, c, chunk: int) -> str:
    """The backward body for these inputs, the one rule: ``"tc"`` for bf16
    that :func:`tc_takes` (L % 16 == 0 up to 128, N and P multiples of 8
    up to 128, 16-byte aligned x / b / c, strides multiples of 8) and whose
    block fits the card's shared memory; else ``"cuda_core"``, f32 and all
    other bf16 (TF32 products would break f32's 1e-4 bar)."""
    p, n = x.shape[3], b.shape[3]
    if ssd_body(x, b, c, chunk) == "tc" and \
            bwd_smem_bytes(chunk, p, n, body="tc") <= SMEM_MAX:
        return "tc"
    return "cuda_core"


def check_bwd_inputs(x, dt, a, b, c, cum, dy, dst, dcum, *,
                     chunk: int) -> None:
    """The backward kernel's rules, on any device: the forward's
    (:func:`check_inputs`), ``cum``, ``dy``, ``dst`` and ``dcum``
    contiguous f32 of the forward outputs' shapes on x's device, and a
    block of the body :func:`ssd_bwd_body` names that fits the card's
    shared memory (:func:`bwd_smem_bytes`)."""
    check_inputs(x, dt, a, b, c)
    bs, s, h, p = x.shape
    n = b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    for name, t, want in (("cum", cum, (bs, nc, chunk, h)),
                          ("dy", dy, (bs, nc, chunk, h, p)),
                          ("dst", dst, (bs, nc, h, n, p)),
                          ("dcum", dcum, (bs, nc, chunk, h))):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 {want} on "
                             f"{x.device}")
    body = ssd_bwd_body(x, b, c, chunk)
    if bwd_smem_bytes(chunk, p, n, body=body) > SMEM_MAX:
        raise ValueError(f"chunk {chunk}, P {p}, N {n} need more than "
                         f"{SMEM_MAX} bytes of shared memory in the "
                         "backward kernel")


def ssd_chunks_bwd(x, dt, a, b, c, cum, dy, dst, dcum, *, chunk: int,
                   cast: bool = True):
    """(dx, ddt, da, db, dc) for :func:`ssd_chunks` (see
    :func:`ssd_chunks_bwd_plain` for the contract).  A CPU tensor goes to
    the plain version (as does a meta one); a CUDA tensor launches
    ``csrc/ssd_chunks_bwd.cu`` on
    the body :func:`ssd_bwd_body` names, or raises.  ``cast=False`` returns
    the f32 gradients before the cast to the inputs' dtypes.  Two calls are
    bitwise equal.  Counts ``ssd_chunks_bwd.launches`` and, per body,
    ``ssd_chunks_bwd.body_launches``."""
    if x.shape[1] % chunk:
        raise ValueError(f"sequence {x.shape[1]} is not a multiple of "
                         f"chunk {chunk}")
    if x.device.type in PLAIN_DEVICES:
        return ssd_chunks_bwd_plain(x, dt, a, b, c, cum, dy, dst, dcum,
                                    chunk=chunk, cast=cast)
    _check(x, dt, a, b, c)
    check_bwd_inputs(x, dt, a, b, c, cum, dy, dst, dcum, chunk=chunk)
    body = ssd_bwd_body(x, b, c, chunk)
    out = _bwd_launch(x, dt, a, b, c, cum, dy, dst, dcum, chunk, cast, body)
    if out[0].numel() and out[3].numel():
        ssd_chunks_bwd.launches += 1
        ssd_chunks_bwd.body_launches[body] += 1
    return out


def _bwd_launch(x, dt, a, b, c, cum, dy, dst, dcum, chunk, cast, body):
    """The gradients of ``body`` on checked CUDA tensors, counting
    nothing: :func:`ssd_chunks_bwd` takes the body :func:`ssd_bwd_body`
    names; ``chip_smoke.py`` also times the bf16 CUDA-core body through
    this.

    ``"cuda_core"`` writes dB and dC per head, (B, S, H, N) f32, and dx in
    f32.  ``"tc"`` sums dB and dC over each cluster of K =
    :func:`cluster_heads` heads of a group inside the kernel and writes
    (B, S, H/K, N) f32, and dx in x's dtype when ``cast`` (rounded once
    from its f32 value).  da leaves per (batch, chunk, head).  One torch
    sum each folds the rest, in a fixed order."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    k = cluster_heads(h // g) if body == "tc" else 1
    f32 = dict(dtype=torch.float32, device=x.device)
    dx_bf16 = body == "tc" and cast
    dx = torch.empty((bs, s, h, p), dtype=x.dtype if dx_bf16 else
                     torch.float32, device=x.device)
    ddt = torch.empty((bs, s, h), **f32)
    da_part = torch.empty((bs, nc, h), **f32)
    db_part = torch.empty((bs, s, h // k, n), **f32)
    dc_part = torch.empty((bs, s, h // k, n), **f32)
    if dx.numel() == 0 or db_part.numel() == 0:
        out = (dx.zero_(), ddt.zero_(), torch.zeros((h,), **f32),
               torch.zeros((bs, s, g, n), **f32),
               torch.zeros((bs, s, g, n), **f32))
        return _cast_grads(out, (x, dt, a, b, c)) if cast else out
    extra = (k, int(dx_bf16)) if body == "tc" else ()
    with torch.cuda.device(x.device):
        rc = _bwd_entry(x.dtype, body)(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), cum.data_ptr(), dy.data_ptr(), dst.data_ptr(),
            dcum.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da_part.data_ptr(), db_part.data_ptr(), dc_part.data_ptr(),
            bs, nc, chunk, h, p, g, n, *extra, x.stride(0), x.stride(1),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunks_bwd kernel ({body}) launch failed "
                           f"with CUDA error {rc}")
    out = (dx, ddt, da_part.sum((0, 1)), fold_groups(db_part, g),
           fold_groups(dc_part, g))
    return _cast_grads(out, (x, dt, a, b, c)) if cast else out


def fold_groups(part, g: int):
    """(B, S, G, N) from a body's (B, S, H/K, N) dB or dC partials, K heads
    summed in each (K = 1 for the CUDA-core body's per-head ones), by one
    torch sum over each group's partials."""
    bs, s, hk, n = part.shape
    return part.view(bs, s, g, hk // g, n).sum(3)


def tc_bwd_info(L: int, P: int, N: int, K: int) -> dict:
    """What a tc backward launch at (L, P, N, K) takes of this card:
    shared memory a block, blocks an SM and clusters of K resident at once
    (the CUDA occupancy calculator's answers)."""
    out = (ctypes.c_longlong * 3)()
    fn = _build.load("ssd_chunks_bwd").ssd_chunks_bwd_tc_info
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    rc = fn(L, P, N, K, out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunks_bwd_tc_info failed with CUDA error "
                           f"{rc}")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1],
            "max_active_clusters": out[2]}


ssd_chunks_bwd.launches = 0
ssd_chunks_bwd.body_launches = dict.fromkeys(BWD_BODIES, 0)


class _SSDChunks(torch.autograd.Function):
    """The forward kernel, saving its inputs and ``cum``; the backward
    kernel, on the gradients of all three outputs."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        y, st, cum = ssd_chunks(x, dt, a, b, c, chunk=chunk)
        ctx.save_for_backward(x, dt, a, b, c, cum)
        ctx.chunk = chunk
        return y, st, cum

    @staticmethod
    def backward(ctx, dy, dst, dcum):
        x, dt, a, b, c, cum = ctx.saved_tensors
        return (*ssd_chunks_bwd(x, dt, a, b, c, cum, dy.contiguous(),
                                dst.contiguous(), dcum.contiguous(),
                                chunk=ctx.chunk), None)


def ssd_chunk_step(x, dt, a, b, c, *, chunk: int):
    """The SSD chunk step as the models call it: :func:`ssd_chunks` alone
    unless autograd records and an input requires a gradient, then the
    autograd Function (its backward through :func:`ssd_chunks_bwd`)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c)):
        return _SSDChunks.apply(x, dt, a, b, c, int(chunk))
    return ssd_chunks(x, dt, a, b, c, chunk=chunk)
