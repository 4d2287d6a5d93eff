"""Time-dependent (T, B) schedules for annealing protocols (port of
``repro.ensemble.protocol``).

A :class:`Schedule` holds piecewise-linear knots as numpy float32 arrays and
is evaluated on the HOST, in numpy float32, one ufunc at a time
(:func:`host_rows`): the same arithmetic as the reference engine's
``_host_lerp`` / ``_host_sched_rows``, so the per-step values the port's
Engine feeds its steps are bitwise the reference's.  The Engine evaluates a
chunk's rows once per chunk and never reads a schedule back from the card.

    values shape (K,)       scalar schedule        -> at(t): t.shape
    values shape (K, 3)     field schedule         -> at(t): t.shape + (3,)
    values shape (K, R)     per-replica ladder     -> at(t): t.shape + (R,)
    values shape (K, R, 3)  per-replica fields     -> at(t): t.shape + (R, 3)

Outside the knot range the endpoint values hold (clamped); duplicate knot
times give exact step discontinuities (quenches).  :class:`SlotSchedules`
stacks R independent schedules, each on its own clock (the replica plan's
per-slot mode, ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

_F32 = np.float32


def _lerp(times: np.ndarray, values: np.ndarray, t) -> np.ndarray:
    """Clamped piecewise-linear interpolation in numpy float32 (the
    reference engine's ``_host_lerp``, op for op)."""
    k = times.shape[0]
    hi = np.clip(np.searchsorted(times, t, side="right"), 1, k - 1)
    lo = hi - 1
    w = np.clip((t - times[lo]) / np.maximum(times[hi] - times[lo],
                                             _F32(1e-30)),
                _F32(0.0), _F32(1.0))
    w = w.reshape(w.shape + (1,) * (values.ndim - 1))
    return values[lo] + w * (values[hi] - values[lo])


def host_rows(sched, t) -> np.ndarray:
    """Evaluate a (Slot)Schedule at host times ``t`` [ps] in numpy float32.

    ``t`` is (n,) for a shared schedule; for a :class:`SlotSchedules`
    (2-d ``times``) it is the (n, R) per-slot clock matrix."""
    times = np.asarray(sched.times, _F32)
    values = np.asarray(sched.values, _F32)
    t = np.asarray(t, _F32)
    if times.ndim == 2:
        return np.stack([_lerp(times[r], values[r], t[:, r])
                         for r in range(times.shape[0])], axis=1)
    return _lerp(times, values, t)


class Schedule(NamedTuple):
    """Piecewise-linear schedule over time [ps]: knots + values."""

    times: np.ndarray   # (K,) non-decreasing knot times [ps], float32
    values: np.ndarray  # (K, *tail) knot values, float32

    def at(self, t) -> np.ndarray:
        """Evaluate at scalar or vector ``t`` [ps] (clamped to endpoints)."""
        return host_rows(self, t)

    @property
    def t_end(self) -> float:
        """Last knot time [ps] (the schedule is constant beyond it)."""
        return float(self.times[-1])


class SlotSchedules(NamedTuple):
    """R independent schedules padded to one knot count K.

        times  (R, K)              per-slot knot times [ps]
        values (R, K) | (R, K, 3)  per-slot knot values

    ``at(t)`` takes a scalar (every slot on one clock) or an (R,) vector
    (each slot on its own) and returns (R,) / (R, 3)."""

    times: np.ndarray
    values: np.ndarray

    def at(self, t) -> np.ndarray:
        r = self.times.shape[0]
        t = np.broadcast_to(np.asarray(t, _F32), (r,))
        return host_rows(self, t[None, :])[0]


def _as_knots(times, values) -> Schedule:
    times = np.asarray(times, _F32)
    values = np.asarray(values, _F32)
    if times.ndim != 1 or times.shape[0] != values.shape[0]:
        raise ValueError(f"knot shapes mismatch: {times.shape} vs "
                         f"{values.shape}")
    if times.shape[0] < 2:
        raise ValueError("a schedule needs >= 2 knots")
    if np.any(np.diff(times) < 0):
        raise ValueError("knot times must be non-decreasing")
    return Schedule(times=times, values=values)


def pad_schedule(sched: Schedule, k: int) -> Schedule:
    """Pad a schedule to exactly ``k`` knots by repeating the final knot;
    evaluation is unchanged bitwise (the extra interval has zero width and
    a lerp weight of exactly 0)."""
    k0 = int(sched.times.shape[0])
    if k0 > k:
        raise ValueError(f"schedule has {k0} knots > pad target {k}")
    if k0 == k:
        return sched
    pad = k - k0
    return Schedule(
        times=np.concatenate([sched.times,
                              np.repeat(sched.times[-1:], pad, axis=0)]),
        values=np.concatenate([sched.values,
                               np.repeat(sched.values[-1:], pad, axis=0)]))


def stack_schedules(scheds: Sequence[Schedule],
                    k: int | None = None) -> SlotSchedules:
    """Stack per-slot schedules, each padded to ``k`` knots (default: the
    largest knot count); all must share one value tail shape."""
    if not scheds:
        raise ValueError("stack_schedules needs at least one schedule")
    if k is None:
        k = max(int(s.times.shape[0]) for s in scheds)
    padded = [pad_schedule(s, k) for s in scheds]
    return SlotSchedules(times=np.stack([s.times for s in padded]),
                         values=np.stack([s.values for s in padded]))


def constant(value) -> Schedule:
    """Time-independent schedule (scalar T, (3,) field, or per-replica)."""
    v = np.asarray(value, _F32)
    return Schedule(times=np.asarray([0.0, 1.0], _F32),
                    values=np.stack([v, v]))


def linear(t0: float, t1: float, v0, v1) -> Schedule:
    """Linear ramp v0 -> v1 over [t0, t1], clamped outside."""
    return _as_knots([t0, t1], [v0, v1])


def piecewise(times: Sequence[float], values) -> Schedule:
    """General piecewise-linear schedule through (times[i], values[i])."""
    return _as_knots(times, values)


def quench(t_q: float, v_hot, v_cold) -> Schedule:
    """Instantaneous drop v_hot -> v_cold at t = t_q (step discontinuity)."""
    return _as_knots([0.0, t_q, t_q, t_q + 1.0],
                     [v_hot, v_hot, v_cold, v_cold])


def field_cooling(t_hot: float, t_cold: float, b_field,
                  *, t_hold: float, t_ramp: float,
                  t_final: float = 0.0) -> tuple[Schedule, Schedule]:
    """The paper's Fig. 9 protocol: hold ``t_hot`` under a perpendicular
    field for ``t_hold`` ps, ramp to ``t_cold`` over ``t_ramp`` ps with the
    field on, then hold.  Returns ``(temperature, field)`` schedules;
    ``b_field`` is a (3,) Tesla vector (or a scalar along z)."""
    b = np.asarray(b_field, _F32)
    if b.ndim == 0:
        b = np.stack([_F32(0.0), _F32(0.0), b])
    temp = piecewise(
        [0.0, t_hold, t_hold + t_ramp, t_hold + t_ramp + max(t_final, 1e-6)],
        [t_hot, t_hot, t_cold, t_cold])
    return temp, constant(b)


def temperature_ladder(t_min: float, t_max: float, n: int) -> np.ndarray:
    """Geometric replica-exchange temperature ladder (n,) [K], ascending."""
    if n < 2:
        return np.asarray([t_min], _F32)
    r = (t_max / t_min) ** (1.0 / (n - 1))
    return np.asarray(t_min * r ** np.arange(n), _F32)
