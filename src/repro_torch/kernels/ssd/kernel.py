"""Mamba-2 SSD chunk step: the hand-written Hopper kernel and its plain
PyTorch version (port of ``repro.kernels.ssd.kernel.ssd_chunks``).

``ssd_chunks`` dispatches on the device of its tensors: a CPU tensor goes to
``ssd_chunks_plain``; a CUDA tensor launches ``csrc/ssd_chunks.cu`` on the
current stream, or raises.  The kernel has two bodies: ``"tc"`` (bf16 on
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


def ssd_chunks_plain(x, dt, a, b, c, *, chunk: int):
    """The per-chunk einsums of the reference kernel, vectorised over
    (B, NC).  x (B,S,H,P), dt (B,S,H) f32, a (H,) f32, b/c (B,S,G,N) ->
    (y_intra (B,NC,L,H,P), states (B,NC,H,N,P), cum (B,NC,L,H)), all f32."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, nc, L = h // g, s // chunk, chunk
    xr = x.float().reshape(bs, nc, L, g, rep, p)
    dtr = dt.float().reshape(bs, nc, L, g, rep)
    br = b.float().reshape(bs, nc, L, g, n)
    cr = c.float().reshape(bs, nc, L, g, n)

    cum = torch.cumsum(dtr * a.float().reshape(g, rep), dim=2)
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
        raise ValueError(f"ssd_chunks runs on CUDA or CPU tensors, got "
                         f"{x.device}")
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
    if x.device.type == "cpu":
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
