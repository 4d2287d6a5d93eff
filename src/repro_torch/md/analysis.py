"""Magnetic-texture analysis: magnetization, the Berg-Luscher topological
charge, and the helix pitch from the spin structure factor (port of
``repro.md.analysis``).

Binned sums (the spin grid of the charge, the slab profile of the pitch)
go through :func:`segment_sum`, which adds in fixed point, so they read
the same bits on every run, on the card too, where a float ``index_add_``
adds with atomics in no fixed order.  It raises where a bin's sum could
leave the fixed-point range rather than wrap.  That check reads one value
back to the host per call, unless a :class:`RangeGuard` is open: it then
collects the largest bin bound on the device for the caller to check
once (the Engine does so with a chunk's health signals).  Each
``accumulate_*`` function takes ``plain=True`` for the ``index_add_``
form it is held against, and ``reduce`` to combine the fixed-point parts
of several ranks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.telemetry.profiling import host_sync


def magnetization(spin: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean spin vector over magnetic sites."""
    if mask is not None:
        w = mask.to(spin.dtype)[:, None]
        return torch.sum(spin * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(spin, dim=0)


_FIXED = 2.0 ** 40     # the fixed-point grid of segment_sum
FIXED_RANGE = 2.0 ** 23   # int64 holds |sum| < 2^63 / 2^40 on that grid


def fixed_point_sums(values: torch.Tensor, keys: torch.Tensor, n: int):
    """The parts of :func:`segment_sum` before its range check: per-bin
    int64 sums of the values on the 2^-40 grid, per-bin sums of |values|
    (a bound on every partial sum, in float64) and the count of non-finite
    values.  All three add exactly (or, the bound, without wrapping), so
    ranks may all-reduce them before :func:`from_fixed_point`."""
    out_shape = (n,) + values.shape[1:]
    v64 = values.to(torch.float64)
    fixed = torch.round(v64 * _FIXED).to(torch.int64)
    acc = torch.zeros(out_shape, dtype=torch.int64,
                      device=values.device).index_add_(0, keys, fixed)
    bound = torch.zeros(out_shape, dtype=torch.float64,
                        device=values.device).index_add_(0, keys, v64.abs())
    bad = torch.sum(~torch.isfinite(values)).reshape(1)
    return acc, bound, bad


class RangeGuard:
    """Defers :func:`segment_sum`'s range check.  Inside ``with guard:`` a
    call keeps its largest finite bin bound on the device (``bound``, a
    float64 scalar, None until a call) instead of reading it back; the
    caller reads it with its own transfer and passes it to :meth:`check`.
    Guards nest; the innermost collects."""

    def __init__(self):
        self.bound = None

    def add(self, largest: torch.Tensor) -> None:
        self.bound = (largest if self.bound is None
                      else torch.maximum(self.bound, largest))

    @staticmethod
    def check(largest: float) -> None:
        """Raises ``OverflowError`` where a bin's |values| added up to
        2^23 or more (its int64 sums could have wrapped)."""
        if largest >= FIXED_RANGE:
            raise OverflowError(
                f"segment_sum: a bin's |values| add up to {largest:.6g} "
                ">= 2^23, past the int64 fixed-point range; the sum would "
                "wrap")

    def __enter__(self) -> "RangeGuard":
        _GUARDS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        for i in range(len(_GUARDS) - 1, -1, -1):
            if _GUARDS[i] is self:
                del _GUARDS[i]
                break


_GUARDS: list[RangeGuard] = []


def from_fixed_point(acc: torch.Tensor, bound: torch.Tensor,
                     bad: torch.Tensor, dtype) -> torch.Tensor:
    """Bin sums from :func:`fixed_point_sums`' parts.  Where a bin's
    partial sums could reach the int64 range (its |values| add up to 2^23
    or more) it raises ``OverflowError`` instead of returning a wrapped
    sum: at once, or, inside a :class:`RangeGuard`, when the guard's
    caller checks.  A non-finite value makes every bin NaN."""
    largest = torch.max(torch.where(torch.isfinite(bound), bound,
                                    torch.zeros_like(bound)))
    if _GUARDS:
        _GUARDS[-1].add(largest)
    else:
        RangeGuard.check(float(largest))
    out = (acc.to(torch.float64) / _FIXED).to(dtype)
    return torch.where(bad == 0, out, torch.full_like(out, float("nan")))


def segment_sum(values: torch.Tensor, keys: torch.Tensor, n: int,
                plain: bool = False, reduce=None) -> torch.Tensor:
    """``out[b] = sum of values[i] over keys[i] == b`` for b < n.

    Deterministic: every value is rounded to a multiple of 2^-40 and the
    sums are taken in int64, where addition is exact, so the order in which
    the card's atomic adds land cannot change a bit.  float32 values of
    magnitude >= 2^-16 lie on that grid exactly.  A bin whose |values| add
    up to 2^23 or more raises ``OverflowError`` (the int64 sums could wrap
    past it), which reads one value back to the host unless a
    :class:`RangeGuard` defers the check.  A non-finite value makes every
    bin NaN.  ``reduce(acc, bound, bad) -> (acc, bound, bad)``
    combines the parts of several ranks (all-reduced sums) before the
    check.  ``plain`` is the float ``index_add_`` it is held against."""
    if plain:
        out = values.new_zeros((n,) + values.shape[1:])
        return out.index_add_(0, keys, values)
    parts = fixed_point_sums(values, keys, n)
    if reduce is not None:
        parts = reduce(*parts)
    return from_fixed_point(*parts, values.dtype)


def _bin(pos: torch.Tensor, box: torch.Tensor, axis: int, n: int):
    return torch.clamp((pos[:, axis] / box[axis] * n).to(torch.int64),
                       0, n - 1)


def spins_on_grid(pos: torch.Tensor, spin: torch.Tensor, box: torch.Tensor,
                  shape: tuple[int, ...]) -> torch.Tensor:
    """Bin spins onto a regular grid (cell-averaged) over the first
    ``len(shape)`` axes; (*shape, 3) unit (or zero) spins per cell."""
    flat = _bin(pos, box, 0, shape[0])
    for d in range(1, len(shape)):
        flat = flat * shape[d] + _bin(pos, box, d, shape[d])
    acc = segment_sum(spin, flat, math.prod(shape))
    nrm = torch.linalg.norm(acc, dim=-1, keepdim=True)
    acc = torch.where(nrm > 1e-12, acc / torch.where(nrm > 1e-12, nrm, 1.0),
                      torch.zeros_like(acc))
    return acc.reshape(*shape, 3)


def accumulate_spin_profile(pos: torch.Tensor, spin: torch.Tensor,
                            box: torch.Tensor, axis: int = 0, n_bins: int = 64,
                            weight: torch.Tensor | None = None,
                            plain: bool = False, reduce=None) -> torch.Tensor:
    """Raw per-slab spin sums (n_bins, 3) along ``axis`` (the accumulation
    half of :func:`helix_pitch`)."""
    s = spin if weight is None else spin * weight[:, None].to(spin.dtype)
    return segment_sum(s, _bin(pos, box, axis, n_bins), n_bins, plain,
                       reduce)


def pitch_from_profile(acc: torch.Tensor, box: torch.Tensor,
                       axis: int = 0) -> torch.Tensor:
    """Pitch [A] from raw per-slab spin sums: each bin normalized, FFT per
    Cartesian component, box / k* for the strongest nonzero mode."""
    nrm = torch.linalg.norm(acc, dim=-1, keepdim=True)
    full = nrm > 1e-12
    prof = torch.where(full, acc / torch.where(full, nrm, 1.0),
                       torch.zeros_like(acc))
    return _pitch_of(prof, box, axis)


def _pitch_of(prof: torch.Tensor, box: torch.Tensor, axis: int):
    power = torch.sum(torch.abs(torch.fft.rfft(prof, dim=0)) ** 2, dim=-1)
    k = torch.argmax(power[1:]) + 1                     # skip k = 0
    return box[axis] / k


def _mean_profile(pos, spin, box, axis, n_bins):
    i = _bin(pos, box, axis, n_bins)
    acc = segment_sum(spin, i, n_bins)
    cnt = segment_sum(torch.ones_like(spin[:, :1]), i, n_bins)
    return acc / torch.clamp(cnt, min=1.0)


def helix_pitch(pos: torch.Tensor, spin: torch.Tensor, box: torch.Tensor,
                axis: int = 0, n_bins: int = 0) -> torch.Tensor:
    """Dominant modulation period [A] of the spin texture along ``axis``
    (the helix pitch of Fig. 4): slab-binned spins, FFT per component,
    box / k* for the strongest nonzero mode."""
    n_bins = n_bins or 64
    if axis == 0:
        return pitch_from_profile(
            accumulate_spin_profile(pos, spin, box, axis, n_bins), box, axis)
    return _pitch_of(_mean_profile(pos, spin, box, axis, n_bins), box, axis)


def topological_charge_grid(s: torch.Tensor) -> torch.Tensor:
    """Berg-Luscher topological charge of a 2-D grid of unit spins (nx,ny,3):
    Q = 1/(4pi) sum over plaquettes of the signed solid angle; Q ~ -1 per
    (Bloch) skyrmion. Periodic boundaries."""
    s2 = torch.roll(s, -1, dims=0)
    s3 = torch.roll(s, -1, dims=1)
    s4 = torch.roll(s2, -1, dims=1)

    def solid_angle(a, b, c):
        num = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
        den = (1.0 + torch.sum(a * b, dim=-1) + torch.sum(b * c, dim=-1)
               + torch.sum(a * c, dim=-1))
        return 2.0 * torch.atan2(num, den)

    omega = solid_angle(s, s2, s4) + solid_angle(s, s4, s3)
    return torch.sum(omega) / (4.0 * math.pi)


def accumulate_spin_grid(pos: torch.Tensor, spin: torch.Tensor,
                         box: torch.Tensor, grid: tuple[int, int] = (32, 32),
                         plane: tuple[int, int] = (0, 1),
                         weight: torch.Tensor | None = None,
                         plain: bool = False, reduce=None) -> torch.Tensor:
    """Raw per-cell spin sums (G0*G1, 3) on the projection plane."""
    ax, ay = plane
    flat = _bin(pos, box, ax, grid[0]) * grid[1] + _bin(pos, box, ay, grid[1])
    s = spin if weight is None else spin * weight[:, None].to(spin.dtype)
    return segment_sum(s, flat, grid[0] * grid[1], plain, reduce)


def charge_from_grid(acc: torch.Tensor,
                     grid: tuple[int, int] = (32, 32)) -> torch.Tensor:
    """Berg-Luscher charge from raw per-cell spin sums; empty cells read +z
    so they add no spurious charge."""
    nrm = torch.linalg.norm(acc, dim=-1, keepdim=True)
    full = nrm > 1e-12
    s = acc / torch.where(full, nrm, torch.ones_like(nrm))
    with host_sync():    # a blocking copy to the card
        zhat = torch.tensor([0.0, 0.0, 1.0], dtype=acc.dtype,
                            device=acc.device)
    s = torch.where(full, s, zhat)
    return topological_charge_grid(s.reshape(grid[0], grid[1], 3))


def topological_charge(pos: torch.Tensor, spin: torch.Tensor,
                       box: torch.Tensor, grid: tuple[int, int] = (32, 32),
                       plane: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Topological charge of the texture projected on a plane (default x-y)."""
    return charge_from_grid(
        accumulate_spin_grid(pos, spin, box, grid, plane), grid)


def skyrmion_count(charge: torch.Tensor) -> torch.Tensor:
    """Integer skyrmion-count estimate |Q| rounded."""
    return torch.round(torch.abs(charge))


def spin_structure_factor(pos: torch.Tensor, spin: torch.Tensor,
                          box: torch.Tensor, n_bins: int = 64,
                          axis: int = 0) -> torch.Tensor:
    """1-D spin structure factor S(k) along an axis (power spectrum)."""
    prof = _mean_profile(pos, spin, box, axis, n_bins)
    return torch.sum(torch.abs(torch.fft.rfft(prof, dim=0)) ** 2, dim=-1)
