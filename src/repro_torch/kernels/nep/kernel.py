"""Wrappers of the hand-written Hopper kernels K1 and K2.

``nep_atom_pass`` (K1, ``csrc/nep_atom_pass.cu``) and ``nep_force_pass``
(K2, ``csrc/nep_force_pass.cu``) dispatch on the device of the tensors they
are given: a CPU tensor goes to the plain PyTorch version in
:mod:`repro_torch.kernels.nep.ref`; a CUDA tensor launches the kernel on the
current stream, or raises - there is no fallback.  Each wrapper checks
device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, raises if the launch reports a CUDA error, and counts its
launches in a plain integer attribute (``nep_atom_pass.launches``).

Replica axis: one launch serves R replicas that share one table.  ``mask``,
``tj``, ``ti`` (and K2's ``idx``) are the table's, (N, M) and (N,); ``dr``
(R, N, M, 3), ``si`` (R, N, 3), ``sj`` (R, N, M, 3) and K2's ``abar``
(R, N, A) are per replica, and so are the outputs.  Without the leading axis
the shapes are the flat ones.  The kernels' grid gains a replica axis over
which each replica runs the flat body, so replica r of a batched launch is
bitwise a flat launch on replica r's inputs; ``launches`` counts launches,
not replicas.

Each kernel has two bodies: ``"warp"`` (one warp per atom, compiled for
the specs of ``WARP_SPECS``) and ``"thread"`` (one thread per atom, any spec
within ``SPEC_BOUNDS``).  :func:`atom_pass_body` and :func:`force_pass_body`
pick one from the spec, never from a failed build or launch;
``nep_atom_pass.body_launches`` and ``nep_force_pass.body_launches`` count
the launches of each.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import _build
from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.potential import NEPSpinParams
from repro_torch.kernels.nep.layout import acc_width
from repro_torch.kernels.nep.ref import atom_pass_plain, force_pass_plain

# compile-time maxima of csrc/nep_common.cuh
SPEC_BOUNDS = {"n_types": 4, "n_rad": 8, "n_ang": 8, "n_spin": 8,
               "l_max": 4, "basis_size": 16, "hidden": 64, "n_onsite": 4}
# specs with compiled warp-per-atom bodies (csrc/nep_common.cuh: ProdSizes,
# SmokeSizes, LoopSizes): (n_types, basis_size, n_rad, n_ang, l_max, n_spin,
# hidden, n_onsite) of configs/fege_spinlattice.py config() and
# smoke_config() and of the md_loop scenario (launch/md_loop.py), with spin.
# K2 reads no MLP, so its body matches on the first six fields.
WARP_SPECS = ((2, 8, 6, 4, 4, 4, 32, 3), (2, 6, 4, 2, 2, 2, 16, 3),
              (2, 6, 4, 2, 2, 2, 32, 3))
BODIES = ("warp", "thread")
MAX_REPLICAS = 65535                 # the CUDA grid's y extent
_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SPEC_ARGS = [_I] * 9 + [_D, _P]     # n_types..spin, cutoff, stream
_ARGTYPES = {                        # ..., n, m, replicas, spec
    "nep_atom_pass": [_P] * 17 + [_I, _I, _I] + _SPEC_ARGS,
    "nep_force_pass": [_P] * 13 + [_I, _I, _I] + _SPEC_ARGS,
}


def check_spec(spec: NEPSpinSpec) -> None:
    """Raise for a spec outside the kernels' compile-time bounds."""
    for field, bound in SPEC_BOUNDS.items():
        if field in ("n_spin", "n_onsite") and not spec.spin:
            continue
        v = getattr(spec, field)
        if not 0 <= v <= bound:
            raise ValueError(f"NEP kernels take 0 <= {field} <= {bound}, "
                             f"got {v}")


def _sizes(spec: NEPSpinSpec) -> tuple:
    return (spec.n_types, spec.basis_size, spec.n_rad, spec.n_ang,
            spec.l_max, spec.n_spin, spec.hidden, spec.n_onsite)


def atom_pass_body(spec: NEPSpinSpec) -> str:
    """K1's body for ``spec``: ``"warp"`` where one is compiled for it,
    else ``"thread"``."""
    return "warp" if spec.spin and _sizes(spec) in WARP_SPECS else "thread"


def force_pass_body(spec: NEPSpinSpec) -> str:
    """K2's body for ``spec``: ``"warp"`` where one is compiled for its
    carrier sizes, else ``"thread"``."""
    compiled = {w[:6] for w in WARP_SPECS}
    return "warp" if spec.spin and _sizes(spec)[:6] in compiled else "thread"


def _pick(name: str, body: str | None, chosen: str) -> str:
    """``body`` (default ``chosen``), raising for one not compiled."""
    body = chosen if body is None else body
    if body not in BODIES or (body == "warp" and chosen != "warp"):
        raise ValueError(f"{name} has no {body!r} body for this spec; "
                         f"WARP_SPECS = {WARP_SPECS}")
    return body


def _entry(name: str, dtype, suffix: str = ""):
    fn = getattr(_build.load(name), f"{name}{suffix}_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(spec, params, dr, mask, ti, tj, si, sj):
    """Check a launch's inputs; returns ``(n, m, lead)`` with ``lead``
    ``(R,)`` for a replica batch, else ``()``."""
    if dr.device.type != "cuda":
        raise ValueError(f"NEP kernels run on CUDA or CPU tensors, got "
                         f"{dr.device}")
    if dr.dtype not in _DTYPES:
        raise TypeError(f"NEP kernels take float32 or float64, got {dr.dtype}")
    check_spec(spec)
    n, m = mask.shape
    lead = tuple(dr.shape[:1]) if dr.dim() == 4 else ()
    if lead and lead[0] > MAX_REPLICAS:
        raise ValueError(f"{lead[0]} replicas in one launch; the grid's "
                         f"replica axis holds at most {MAX_REPLICAS}")
    dev, dt = dr.device, dr.dtype
    _check("dr", dr, lead + (n, m, 3), dt, dev)
    _check("mask", mask, (n, m), torch.bool, dev)
    _check("ti", ti, (n,), torch.int32, dev)
    _check("tj", tj, (n, m), torch.int32, dev)
    _check("si", si, lead + (n, 3), dt, dev)
    _check("sj", sj, lead + (n, m, 3), dt, dev)
    t, k, h, d = spec.n_types, spec.basis_size, spec.hidden, spec.n_desc
    shapes = {"c_rad": (t, t, spec.n_rad, k), "c_ang": (t, t, spec.n_ang, k),
              "c_spin": (t, t, spec.n_spin, k), "w1": (t, d, h), "b1": (t, h),
              "w2": (t, h), "b2": (t,), "q_scale": (d,)}
    for field, shape in shapes.items():
        _check(field, getattr(params, field), shape, dt, dev)
    return n, m, lead


def _spec_args(spec: NEPSpinSpec, device):
    return (spec.n_types, spec.basis_size, spec.n_rad, spec.n_ang,
            spec.l_max, spec.n_spin, spec.n_onsite, spec.hidden,
            int(spec.spin), float(spec.cutoff),
            torch.cuda.current_stream(device).cuda_stream)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{rc}")


def nep_atom_pass(spec: NEPSpinSpec, params: NEPSpinParams, dr, mask, ti, tj,
                  si, sj, *, body: str | None = None):
    """K1: ``(e (N,), hdir (N,3), abar (N, A))``.

    dr (N,M,3), mask (N,M) bool, ti (N,) / tj (N,M) int32, si (N,3),
    sj (N,M,3); a replica batch adds a leading R to dr, si, sj and the
    outputs (module docstring).  ``hdir = -dE_i/dS_i`` at fixed
    accumulators; ``abar`` is the packed dE_i/dA_i
    (:mod:`repro_torch.kernels.nep.layout`).  ``body`` defaults to
    :func:`atom_pass_body`; ``"thread"`` runs the thread-per-atom body for
    any spec, ``"warp"`` raises for a spec it was not compiled for (on any device: a CPU tensor runs the plain version
    whatever the body)."""
    body = _pick("K1", body, atom_pass_body(spec))
    if dr.device.type == "cpu":
        return atom_pass_plain(spec, params, dr, mask, ti, tj, si, sj)
    n, m, lead = _check_common(spec, params, dr, mask, ti, tj, si, sj)
    e = torch.empty(lead + (n,), dtype=dr.dtype, device=dr.device)
    hdir = torch.empty(lead + (n, 3), dtype=dr.dtype, device=dr.device)
    abar = torch.empty(lead + (n, acc_width(spec)), dtype=dr.dtype,
                       device=dr.device)
    if e.numel() == 0:
        return e, hdir, abar
    with torch.cuda.device(dr.device):
        rc = _entry("nep_atom_pass", dr.dtype,
                    "_warp" if body == "warp" else "")(
            dr.data_ptr(), mask.data_ptr(), ti.data_ptr(), tj.data_ptr(),
            si.data_ptr(), sj.data_ptr(), *(p.data_ptr() for p in params),
            e.data_ptr(), hdir.data_ptr(), abar.data_ptr(), n, m,
            lead[0] if lead else 1, *_spec_args(spec, dr.device))
    _raise_on("nep_atom_pass", rc)
    nep_atom_pass.launches += 1
    nep_atom_pass.body_launches[body] += 1
    return e, hdir, abar


nep_atom_pass.launches = 0
nep_atom_pass.body_launches = dict.fromkeys(BODIES, 0)


def nep_force_pass(spec: NEPSpinSpec, params: NEPSpinParams, dr, mask, idx,
                   ti, tj, si, sj, abar, *, body: str | None = None):
    """K2: ``(F (N,3), h2 (N,3))`` from K1's packed adjoints ``abar``
    (N, A), read through ``idx`` (N,M) int32 for each neighbor; a replica
    batch adds a leading R to dr, si, sj, abar and the outputs, and reads
    replica r's neighbor rows.  ``body``
    defaults to :func:`force_pass_body`; ``"thread"`` runs the
    thread-per-atom body for any spec, ``"warp"`` raises for a spec it was
    not compiled for (on any device)."""
    body = _pick("K2", body, force_pass_body(spec))
    if dr.device.type == "cpu":
        return force_pass_plain(spec, params, dr, mask, idx, ti, tj, si, sj,
                                abar)
    n, m, lead = _check_common(spec, params, dr, mask, ti, tj, si, sj)
    _check("idx", idx, (n, m), torch.int32, dr.device)
    _check("abar", abar, lead + (n, acc_width(spec)), dr.dtype, dr.device)
    f = torch.empty(lead + (n, 3), dtype=dr.dtype, device=dr.device)
    h2 = torch.empty(lead + (n, 3), dtype=dr.dtype, device=dr.device)
    if f.numel() == 0:
        return f, h2
    with torch.cuda.device(dr.device):
        rc = _entry("nep_force_pass", dr.dtype,
                    "_warp" if body == "warp" else "")(
            dr.data_ptr(), mask.data_ptr(), idx.data_ptr(), ti.data_ptr(),
            tj.data_ptr(), si.data_ptr(), sj.data_ptr(),
            params.c_rad.data_ptr(), params.c_ang.data_ptr(),
            params.c_spin.data_ptr(), abar.data_ptr(), f.data_ptr(),
            h2.data_ptr(), n, m, lead[0] if lead else 1,
            *_spec_args(spec, dr.device))
    _raise_on("nep_force_pass", rc)
    nep_force_pass.launches += 1
    nep_force_pass.body_launches[body] += 1
    return f, h2


nep_force_pass.launches = 0
nep_force_pass.body_launches = dict.fromkeys(BODIES, 0)
