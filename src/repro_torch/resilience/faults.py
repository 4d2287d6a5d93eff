"""Deterministic seeded fault injection for the engine (port of
``repro.resilience.faults``).

A :class:`FaultPlan` is pure data - a tuple of :class:`Fault` records and a
seed - so a failure campaign replays exactly.  :func:`install_faults`
compiles it into a host-side injector on the engine's chunk-boundary hook
(``engine._fault_injector``): right before a chunk whose step window covers
a fault's trigger step, the injector copies the target carry leaf to the
host, corrupts it, and writes it back on the leaf's device in the leaf's
dtype.  It works on the flat, replica and Sharded plans alike (on a
replica carry the rows of every replica are candidates; on the Sharded
plan every rank runs its own injector on its own slab, so ``nan`` and
``bit_flip`` corrupt each rank's occupied slots).

Fault kinds and what they model:

``nan``        a transient nonsense value: NaN written into ``count``
               elements of a leaf.
``bit_flip``   silent data corruption: XOR one bit of one element's raw
               representation (the bit clamped to 30 for f32, 62 for f64).
               High exponent bits make it detectable through the energy and
               non-finite health signals.
``overflow``   a migration overflow on one rank: adds ``count`` to the
               carry's per-rank ``n_dropped`` entry of rank ``device``, and
               keeps firing until the engine's cell capacity exceeds the
               capacity at install time - it models *this layout is too
               small*, which the supervisor's capacity rung fixes.
               Sharded plan only.
``halo``       corruption of ONE rank's boundary face (a bad link): NaN in
               the occupied position slots of rank ``device``'s last local
               x-cell layer (of every local replica).  Sharded plan only.
``crash``      the host dies: ``SIGKILL`` to the current process (for
               kill-and-resume runs in a child process).

``device`` is a rank's linear index over the whole mesh, every dimension
folded (the replica one included), taken modulo the mesh's size.

Transient faults fire once ever (``once=True``): after the supervisor
rolls back past the trigger step, the re-run sails through.  ``once=False``
fires on every pass through the window, e.g. to force the degradation
ladder; with ``while_dt_ge=<dt>`` it models an instability that a smaller
step fixes - the fault goes inert once the supervisor's dt ladder drops
``engine.cfg.dt`` below the threshold.

Element choice is the reference's: ``numpy.random.default_rng(
SeedSequence([seed, index]))`` picks the rows, then the columns, so a plan
corrupts the same elements as the reference's on a carry of the same
shape.
"""
from __future__ import annotations

import dataclasses
import os
import signal as _signal

import numpy as np
import torch

_KINDS = ("nan", "bit_flip", "overflow", "halo", "crash")
_LEAVES = ("pos", "vel", "spin", "force")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One seeded fault; fires at the first chunk whose step window
    ``[step0, step0 + n)`` contains :attr:`step`."""

    kind: str                 # one of _KINDS
    step: int                 # global step the fault triggers at
    leaf: str = "force"       # target carry leaf (nan / bit_flip)
    device: int = 0           # target rank (overflow / halo)
    count: int = 1            # elements corrupted / atoms dropped
    bit: int = 62             # bit index for bit_flip (f64: 62 = top
                              # exponent bit; f32 tensors clamp to 30)
    once: bool = True         # transient (fire once ever) vs persistent
    while_dt_ge: float | None = None   # fire only while cfg.dt >= this

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")
        if self.leaf not in _LEAVES:
            raise ValueError(f"unknown fault leaf {self.leaf!r}; "
                             f"expected one of {_LEAVES}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A reproducible failure campaign: faults and the seed that picks the
    corrupted elements."""

    faults: tuple = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))


def install_faults(engine, plan: FaultPlan, *,
                   runlog=None) -> "FaultInjector":
    """Arm ``engine`` with ``plan``; returns the injector (its ``fired``
    lists the firings).  ``runlog`` appends a ``fault_injected`` record per
    firing."""
    inj = FaultInjector(engine, plan, runlog=runlog)
    engine._fault_injector = inj
    return inj


def _split(carry):
    """(state, force field, rebuild) for either plan's carry."""
    if hasattr(carry, "states"):        # ReplicaCarry
        return carry.states, carry.ffs, (
            lambda st, ff: carry._replace(states=st, ffs=ff))
    return carry.state, carry.ff, (
        lambda st, ff: carry._replace(state=st, ff=ff))


class FaultInjector:
    """The compiled form of a :class:`FaultPlan` for one engine."""

    def __init__(self, engine, plan: FaultPlan, *, runlog=None):
        from repro_torch.parallel.plan import Sharded
        self.plan = plan
        self.runlog = runlog
        self.fired: list[dict] = []
        self._done: set[int] = set()
        sharded = isinstance(engine.plan, Sharded)
        for f in plan.faults:
            if f.kind in ("overflow", "halo") and not sharded:
                raise ValueError(f"fault kind {f.kind!r} targets the "
                                 "sharded plan's per-device state; engine "
                                 f"plan is {type(engine.plan).__name__}")
        # overflow models "the capacity at install is too small": it goes
        # inert once the engine's capacity grows past this
        self._cap0 = (int(engine._rplan.dspec.capacity) if sharded
                      else None)

    def __call__(self, engine, carry, n: int):
        state, _, _ = _split(carry)
        step0 = int(np.asarray(state.step).reshape(-1)[0])
        for i, f in enumerate(self.plan.faults):
            if i in self._done or not (step0 <= f.step < step0 + n):
                continue
            if (f.kind == "overflow"
                    and int(engine._rplan.dspec.capacity) > self._cap0):
                continue    # the capacity rung fixed it; the fault is inert
            if (f.while_dt_ge is not None
                    and float(engine.cfg.dt) < f.while_dt_ge):
                continue    # the dt ladder fixed it; the fault is inert
            if f.once:
                self._done.add(i)
            record = {"kind": f.kind, "fault_step": f.step,
                      "chunk_step": step0, "leaf": f.leaf,
                      "device": f.device}
            self.fired.append(record)
            if self.runlog is not None:
                from repro_torch.telemetry.runlog import append_event
                append_event(self.runlog, "fault_injected", **record)
            carry = self._fire(engine, carry, f, i)
        return carry

    def _fire(self, engine, carry, f: Fault, index: int):
        if f.kind == "crash":
            os.kill(os.getpid(), _signal.SIGKILL)
        if f.kind == "overflow":
            vec = np.array(carry.n_dropped, copy=True).reshape(-1)
            vec[f.device % vec.size] += f.count
            return carry._replace(n_dropped=vec)
        if f.kind == "halo":
            rp = engine._rplan
            if f.device % rp.world != rp.rank:
                return carry            # another rank's face
            lead = carry.state.types.dim() - 4
            face = (slice(None),) * lead + (-1,)     # last local x layer
            pos = carry.state.pos.clone()
            occ = carry.state.types[face] >= 0
            layer = pos[face]
            layer[occ] = float("nan")
            pos[face] = layer
            return carry._replace(state=carry.state._replace(pos=pos))
        rng = np.random.default_rng(
            np.random.SeedSequence([self.plan.seed, index]))
        state, ff, rebuild = _split(carry)
        arr = {"pos": state.pos, "vel": state.vel, "spin": state.spin,
               "force": ff.force}[f.leaf]
        host = arr.detach().cpu().numpy().copy()
        # occupied rows only (every row of the port's carries is an atom)
        occ = np.asarray(state.types.cpu()).reshape(-1) >= 0
        flat = host.reshape(-1, host.shape[-1])
        cand = np.nonzero(occ)[0]
        rows = rng.choice(cand, size=min(f.count, cand.size), replace=False)
        cols = rng.integers(0, flat.shape[-1], size=rows.size)
        if f.kind == "nan":
            flat[rows, cols] = np.nan
        else:                           # bit_flip
            bits = host.dtype.itemsize * 8
            uview = flat.view(np.uint64 if bits == 64 else np.uint32)
            uview[rows, cols] ^= np.asarray(1 << min(f.bit, bits - 2),
                                            uview.dtype)
        # back on the leaf's device, in its dtype
        arr = torch.from_numpy(host).to(device=arr.device, dtype=arr.dtype)
        if f.leaf == "force":
            ff = ff._replace(force=arr)
        else:
            state = state._replace(**{f.leaf: arr})
        return rebuild(state, ff)
