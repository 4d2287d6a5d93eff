"""Flash attention with a gradient: the hand-written Hopper kernels and
their plain PyTorch versions (port of
``repro.kernels.attention.kernel.flash_attention_fwd``, and with the
contract of ``repro.kernels.attention.ops.flash_attention``).

``flash_attention_fwd`` dispatches on the device of its tensors: a CPU
tensor goes to ``flash_attention_plain``; a CUDA tensor launches
``csrc/flash_attention_fwd.cu`` on the current stream, or raises; a
``meta`` tensor (the dry run's shape-only route) also goes to the plain
version, which gives the shapes and whose products the cost counter
counts.  No other device is accepted.  bf16
runs a tensor-core body (``mma.sync``, ``ldmatrix``, ``cp.async``), whose
shape and alignment limits :func:`check_bf16_layout` states; f32 runs the
CUDA-core body.  :func:`fa_body` names the body a call takes (the
tensor-core body has three instantiations: ``tc_exact`` for d = dv = 80,
``tc_k8`` for d <= 128 in 8 k-steps of 16, d % 16 == 8 zero-padded, and
``tc_k12`` for 128 < d <= 192).  It counts its launches in
``flash_attention_fwd.launches`` and, by body, in ``.body_launches``.
With ``return_lse=True`` it also returns each row's f32 log-sum-exp
(B, H, S), which every body writes from its running max and sum.

``flash_attention_bwd`` is the gradient (``csrc/flash_attention_bwd.cu``:
a dK/dV pass and a dQ pass, no atomics; bf16 on the tensor cores, f32 on
the CUDA cores); the reference has no backward kernel (it differentiates
its XLA ``chunked_attention``).  Its plain version is
``flash_attention_bwd_plain``, its width limits :func:`check_bwd_widths`
and, in bf16, :func:`check_bf16_layout` over q, k, v and dO.
:func:`fa_bwd_body` names the body a call takes.  It counts
``flash_attention_bwd.launches`` (calls that launched, two kernels each),
``.pass_launches`` by pass and ``.body_launches`` by body.
:func:`flash_attention` is what the models call: the kernel forward alone
when no input needs a gradient (serving launches exactly that), else the
``torch.autograd.Function`` whose forward asks for ``lse`` and whose
backward runs ``flash_attention_bwd``.

All read the model's layout, q (B,S,H,d) and k/v (B,T,Hkv,d/dv) ->
(B,S,H,dv), where the reference kernel takes (B*H, S, d) after a transpose,
so the reference's ``ops`` wrapper and its transposes have no counterpart.  Positions are the
row indices 0..S-1 and 0..T-1: causal keeps k_pos <= q_pos, a window keeps
k_pos > q_pos - window, and keys past T do not exist.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build

NEG_INF = -1e30
PLAIN_ROWS = 256        # query rows per step of the plain version
MAX_DV = 128
MAX_D_BF16 = 192
MAX_SEQ_STRIDE = 2 ** 23    # a tile's <= 256 rows stay in 32-bit offsets
SMEM_MAX = 232448
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = ([_P] * 4 + [_I] * 9 + [ctypes.c_float] + [_L] * 9
             + [_P, _I, _P])
_BWD_ARGTYPES = ([_P] * 9 + [_I] * 9 + [ctypes.c_float] + [_L] * 12
                 + [_P, _I])
BODIES = ("cuda_core", "tc_exact", "tc_k8", "tc_k12")   # the C body index
BWD_BODIES = ("cuda_core", "tc_k8", "tc_k12")           # the backward's
BWD_PASSES = ("dkdv", "dq")
MAX_D_BWD = 192
PLAIN_DEVICES = ("cpu", "meta")   # devices whose tensors take the plain route


def _visible(s0, sb, t, causal, window, device):
    """(sb, t) mask of the keys query rows s0..s0+sb-1 see."""
    k_pos = torch.arange(t, device=device)
    q_pos = torch.arange(s0, s0 + sb, device=device)[:, None]
    ok = torch.ones((sb, t), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window:
        ok &= k_pos > q_pos - window
    return ok


def flash_attention_plain(q, k, v, *, causal=True, window=0,
                          return_lse=False):
    """Masked softmax attention in f32, ``PLAIN_ROWS`` query rows at a time
    (no S x T block of the whole sequence).  Returns (B,S,H,dv) in q's
    dtype, and with ``return_lse`` also each row's f32 log-sum-exp of its
    scaled, masked scores, (B,H,S)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kf, vf = k.float(), v.float()
    out = torch.empty((b, s, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for s0 in range(0, s, PLAIN_ROWS):
        qb = q[:, s0:s0 + PLAIN_ROWS].float() * d ** -0.5
        sb = qb.shape[1]
        qb = qb.reshape(b, sb, hkv, rep, d)
        sco = torch.einsum("bsgrd,btgd->bgrst", qb, kf)
        ok = _visible(s0, sb, t, causal, window, q.device)
        sco = torch.where(ok, sco, NEG_INF)
        prob = torch.softmax(sco, dim=-1)
        if return_lse:
            lse[:, :, s0:s0 + sb] = torch.logsumexp(sco, dim=-1).reshape(
                b, h, sb)
        ob = torch.einsum("bgrst,btge->bsgre", prob, vf)
        out[:, s0:s0 + sb] = ob.reshape(b, sb, h, -1).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal=True,
                              window=0):
    """The gradient of :func:`flash_attention_plain` in f32 from the
    forward's output ``o`` and row log-sum-exp ``lse`` (B,H,S), given
    ``do`` = dL/do, ``PLAIN_ROWS`` query rows at a time: P = exp(S * scale
    - lse) on the visible keys, D = rowsum(do * o), dS = P (dP - D).
    Returns (dq, dk, dv) in q's dtype."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep, scale = h // hkv, d ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for s0 in range(0, s, PLAIN_ROWS):
        qb = q[:, s0:s0 + PLAIN_ROWS].float() * scale
        sb = qb.shape[1]
        qb = qb.reshape(b, sb, hkv, rep, d)
        dob = do[:, s0:s0 + sb].float().reshape(b, sb, hkv, rep, -1)
        ob = o[:, s0:s0 + sb].float().reshape(b, sb, hkv, rep, -1)
        lb = lse[:, :, s0:s0 + sb].reshape(b, hkv, rep, sb, 1)
        sco = torch.einsum("bsgrd,btgd->bgrst", qb, kf)
        ok = _visible(s0, sb, t, causal, window, q.device)
        prob = torch.where(ok, torch.exp(sco - lb), 0.0)
        dp = torch.einsum("bsgre,btge->bgrst", dob, vf)
        dsum = (dob * ob).sum(-1).permute(0, 2, 3, 1)[..., None]
        ds = prob * (dp - dsum)
        dv += torch.einsum("bgrst,bsgre->btge", prob, dob)
        dk += torch.einsum("bgrst,bsgrd->btgd", ds, qb)
        dqb = torch.einsum("bgrst,btgd->bsgrd", ds, kf) * scale
        dq[:, s0:s0 + sb] = dqb.reshape(b, sb, h, d).to(q.dtype)
    return dq, dk.to(q.dtype), dv.to(q.dtype)


def fa_body(dtype, d: int, dv: int) -> str:
    """The body a CUDA call of this dtype and width takes: f32 the
    CUDA-core one; bf16 the exact d = dv = 80 instantiation, else the
    guarded one of 8 k-steps up to d = 128 or of 12 above.  The one rule:
    the C launcher takes the body's index in ``BODIES`` and checks only
    that the instantiation holds the widths."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    if d == 80 and dv == 80:
        return "tc_exact"
    return "tc_k8" if d <= 128 else "tc_k12"


def _entry(dtype):
    fn = getattr(_build.load("flash_attention_fwd"),
                 f"flash_attention_fwd_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _smem_bytes(d: int, dv: int) -> int:
    dv16 = -(-dv // 16) * 16
    return 4 * (2 * d * 68 + 64 * dv16 + 64 * 68)


def check_bf16_layout(d: int, dv: int, data_ptrs, strides) -> None:
    """Raise ValueError unless the bf16 tensor-core bodies (forward and
    backward) take this layout: d and dv multiples of 8 (16 bytes, one
    ``cp.async`` chunk; a d of 16k + 8 runs its last mma k-step on 8 zero
    columns), d at most 192 and dv at most 128; every base pointer and every
    stride of the leading three dimensions 16-byte aligned (``cp.async``
    copies 16 bytes at a time; strides are in bf16 elements, 8 to 16
    bytes); and each sequence stride (``strides[i][1]`` of each tensor's
    (batch, seq, head) strides) below ``MAX_SEQ_STRIDE`` elements, since
    offsets within a tile are 32-bit.  The tensors are those the kernel
    copies: q, k and v, and for the backward dO."""
    if d % 8 or not 0 < d <= MAX_D_BF16:
        raise ValueError(f"the bf16 flash kernel takes d a multiple of 8 "
                         f"up to {MAX_D_BF16}, got d {d}")
    if dv % 8 or not 0 < dv <= MAX_DV:
        raise ValueError(f"the bf16 flash kernel takes dv a multiple of 8 "
                         f"up to {MAX_DV}, got dv {dv}")
    if any(p % 16 for p in data_ptrs):
        raise ValueError("the bf16 flash kernel needs q, k, v (and dO) to "
                         "start on 16-byte boundaries")
    flat = [st for x in strides for st in x]
    if any(st % 8 for st in flat):
        raise ValueError(f"the bf16 flash kernel needs the strides of q, k, "
                         f"v (and dO) to be multiples of 8 elements (16 "
                         f"bytes), got {tuple(flat)}")
    if any(x[1] >= MAX_SEQ_STRIDE for x in strides):
        raise ValueError(f"the bf16 flash kernel needs sequence strides "
                         f"below {MAX_SEQ_STRIDE} elements")


def _check(q, k, v, do=None):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on CUDA, CPU or meta "
                         f"tensors, got {q.device}")
    check_inputs(q, k, v, do)


def check_inputs(q, k, v, do=None) -> None:
    """What the CUDA wrappers check before a launch, on any device: dtypes,
    shapes, a contiguous last dimension and the kernel's limits; in bf16
    the tensor-core layout (:func:`check_bf16_layout`) of q, k, v and, for
    the backward, ``do``."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} must be on {q.device} with dtype "
                             f"{q.dtype}")
        if x.dim() != 4:
            raise ValueError(f"{name} must be (B, T, Hkv, d)")
    if q.dim() != 4:
        raise ValueError("q must be (B, S, H, d)")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"heads {h} must be a multiple of kv heads "
                         f"{k.shape[2]}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the last dimension of q, k and v must be "
                         "contiguous")
    dv = v.shape[3]
    if q.dtype == torch.bfloat16:
        xs = (q, k, v) if do is None else (q, k, v, do)
        check_bf16_layout(d, dv, [x.data_ptr() for x in xs],
                          [x.stride()[:3] for x in xs])
    elif dv > MAX_DV or _smem_bytes(d, dv) > SMEM_MAX:
        raise ValueError(f"d {d}, dv {dv} exceed the kernel's limits "
                         f"(dv <= {MAX_DV}, {SMEM_MAX} bytes of shared "
                         "memory)")


def flash_attention_fwd(q, k, v, *, causal=True, window=0,
                        return_lse=False):
    """q (B,S,H,d), k (B,T,Hkv,d), v (B,T,Hkv,dv) -> (B,S,H,dv) in q's
    dtype (and, with ``return_lse``, the rows' f32 log-sum-exp (B,H,S)).
    f32 in: f32 math on the CUDA cores.  bf16 in: bf16 products on the
    tensor cores with f32 accumulation, scores and softmax in f32, P V as
    bf16 hi and lo products."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    _check(q, k, v)
    b, s, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    body = fa_body(q.dtype, d, dv)
    with torch.cuda.device(q.device):
        rc = _entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, hkv, d, dv, int(bool(causal)), int(window),
            d ** -0.5, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
            BODIES.index(body), None if lse is None else lse.data_ptr())
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed with "
                           f"CUDA error {rc}")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.body_launches[body] += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
flash_attention_fwd.body_launches = dict.fromkeys(BODIES, 0)


def check_bwd_widths(d: int, dv: int) -> None:
    """Raise ValueError unless the backward kernels take these widths: the
    zoo trains at d = 64, 80, 120, 128 and d = 192 with dv = 128 (MLA), and
    each thread of the CUDA-core bodies holds 12 dQ/dK and 8 dV columns,
    so 0 < d <= 192 and 0 < dv <= 128 (both passes then fit the card's
    shared memory)."""
    if not 0 < d <= MAX_D_BWD:
        raise ValueError(f"the flash backward kernel takes d up to "
                         f"{MAX_D_BWD}, got d {d}")
    if not 0 < dv <= MAX_DV:
        raise ValueError(f"the flash backward kernel takes dv up to "
                         f"{MAX_DV}, got dv {dv}")


def fa_bwd_body(dtype, d: int, dv: int) -> str:
    """The backward body a CUDA call of this dtype and width takes: f32 the
    CUDA-core one; bf16 the tensor-core one with 8 k-steps over d up to
    d = 128 (h2o's 120 on a zeroed pad chunk), else the one with 12 (MLA's
    d = 192 / dv = 128).  The one rule: the C launcher takes the body's
    index in ``BWD_BODIES`` and checks only that it holds the widths."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    return "tc_k8" if d <= 128 else "tc_k12"


def _bwd_entry(dtype):
    fn = getattr(_build.load("flash_attention_bwd"),
                 f"flash_attention_bwd_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _BWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    """(dq, dk, dv) in q's dtype for :func:`flash_attention_fwd`'s output
    ``o`` and log-sum-exp ``lse`` at upstream gradient ``do`` (B,S,H,dv).
    A CPU or meta tensor goes to :func:`flash_attention_bwd_plain`; a CUDA one
    launches ``csrc/flash_attention_bwd.cu``'s two passes on the body
    :func:`fa_bwd_body` names (D = rowsum(do * o) is one torch reduction in
    f32 before them), or raises."""
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window)
    _check(q, k, v, do)
    b, s, h, d = q.shape
    dvw = v.shape[3]
    check_bwd_widths(d, dvw)
    want = (b, s, h, dvw)
    for name, x in (("o", o), ("do", do)):
        if (tuple(x.shape) != want or x.dtype != q.dtype
                or x.device != q.device or x.stride(3) != 1):
            raise ValueError(f"{name} must be {want} in {q.dtype} on "
                             f"{q.device} with a contiguous last dimension")
    if (lse.shape != (b, h, s) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous f32 ({b}, {h}, {s})")
    body = fa_bwd_body(q.dtype, d, dvw)
    out = _bwd_launch(q, k, v, o, lse, do, causal, window, body)
    if out[0].numel() and out[1].numel():
        flash_attention_bwd.launches += 1
        flash_attention_bwd.body_launches[body] += 1
        for name in BWD_PASSES:
            flash_attention_bwd.pass_launches[name] += 1
    return out


def _bwd_launch(q, k, v, o, lse, do, causal, window, body):
    """The two passes of ``body`` on checked CUDA tensors, counting
    nothing: :func:`flash_attention_bwd` takes the body
    :func:`fa_bwd_body` names; ``chip_smoke.py`` also times the bf16
    CUDA-core body through this."""
    b, s, h, d = q.shape
    t, hkv, dvw = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, t, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t, hkv, dvw), dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    with torch.cuda.device(q.device):
        rc = _bwd_entry(q.dtype)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, s, t, h, hkv, d, dvw, int(bool(causal)),
            int(window), d ** -0.5, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3],
            torch.cuda.current_stream(q.device).cuda_stream,
            BWD_BODIES.index(body))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed with "
                           f"CUDA error {rc}")
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.pass_launches = dict.fromkeys(BWD_PASSES, 0)
flash_attention_bwd.body_launches = dict.fromkeys(BWD_BODIES, 0)


class _FlashAttention(torch.autograd.Function):
    """FA's forward kernel with ``lse``, and its backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                     **ctx.mask), None, None)


def flash_attention(q, k, v, *, causal=True, window=0):
    """Attention as the models call it: :func:`flash_attention_fwd` alone
    unless autograd records and an input requires a gradient, then the
    autograd Function (forward with ``lse``, backward through
    :func:`flash_attention_bwd`)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), int(window))
    return flash_attention_fwd(q, k, v, causal=causal, window=window)
