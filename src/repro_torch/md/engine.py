"""The spin-lattice simulation engine, flat single-device plan (port of
``repro.md.engine``).

A chunked loop over :func:`repro_torch.md.integrator.make_fused_step`:
before every step it runs the half-skin test and, when it trips, rebuilds
the neighbor table (re-sorting the rows into linked-cell order first when
the plan asks for it), gathers the blocks and re-evaluates the potential;
then it steps.  On top of that loop:

* **schedules** - ``temperature`` / ``field`` take None, a constant or a
  :class:`repro_torch.ensemble.protocol.Schedule`.  A chunk's per-step
  values are evaluated once per chunk on the host in numpy float32
  (:func:`~repro_torch.ensemble.protocol.host_rows`, bitwise the
  reference's rows); temperatures reach the step as Python floats and the
  field rows go to the device as one (n, 3) tensor per chunk, so a
  schedule adds no host sync;
* **observables** - ``energy``, ``kinetic``, ``magnetization``,
  ``charge``, ``skyrmion_count``, ``pitch`` (:mod:`repro_torch.md.analysis`)
  at chunk ends, or every ``obs_every`` steps; they stay on the device
  until the chunk ends and come back with the health signals in one
  transfer, which also carries the range check of their fixed-point bin
  sums (:class:`repro_torch.md.analysis.RangeGuard`);
* **callbacks** - ``run(callback=...)`` sees the engine after every chunk,
  its observation state synced, and may swap ``engine.state``;
* **checkpoint-restart** - :meth:`Engine.save` / :meth:`Engine.restore`
  snapshot the carry and the run's ``torch.Generator`` at a chunk boundary
  (:mod:`repro_torch.ckpt.checkpoint`); a resumed run is bitwise the
  uninterrupted one.  The neighbor blocks are not stored: they are
  re-derived from the saved table and positions by the same arithmetic
  that made them;
* **telemetry** - ``run(telemetry=...)``: a JSONL runlog, health gating
  with :class:`~repro_torch.telemetry.monitor.HealthError`, and an
  optional profiler trace (:mod:`repro_torch.telemetry`).

Host syncs: the reference runs the rebuild test inside its compiled scan
behind a ``lax.cond``.  Here the test runs on the device every step and is
read back with one ``.item()`` - one host sync per step; capturing a chunk
as a CUDA graph with a device-side rebuild flag would remove it.  A
rebuild adds two more (the linked-cell binning's index and its overflow
check; a third, the table's transpose, for potentials that sum pair
reactions), and a chunk end one readback.  Each sync runs in a counted
``repro.sync`` range (:func:`repro_torch.telemetry.profiling.host_sync`);
the runlog's chunk records carry the count as ``host_syncs``.

Profiler ranges, by layer: ``repro.run`` (one :meth:`Engine.run`),
``repro.chunk`` (one chunk with its readback, health gate, runlog,
checkpoint and callback), ``repro.step`` (one step), ``repro.skin_test``,
``repro.rebuild``, ``repro.integrate`` with ``repro.refresh`` (the ``dr``
refresh after the drift) and ``repro.force`` inside it,
``repro.observe`` and ``repro.readback``.

The ``Replicated`` plan runs R replicas of one crystal as one batch on one
card (``state`` (R, N, ...), or a flat state tiled R times): one shared
neighbor table built from the replica-mean positions and rebuilt when any
replica trips the half-skin test, a per-replica ``dr`` block, one K1 and
one K2 launch per evaluation for all replicas (the autograd potentials loop
over them), one ``torch.Generator`` per replica, and per-replica
temperatures (R,) and fields (R, 3).  Replica r's numbers are bitwise a
flat step's on its own inputs.  ``per_slot=True`` treats every slot as an
independent job: its own clock (``state.step`` row) for the schedules,
which may be :class:`~repro_torch.ensemble.protocol.SlotSchedules`, its
own generator, per-slot health vectors, and :meth:`Engine.write_slots` to
seat a new job in a slot between chunks, evaluated by the same routine as
every other evaluation, so the other slots keep their bits.
:meth:`Engine.shard_replicas` (or ``Replicated(devices=...)``) splits the
replica axis over ranks: each holds R / ranks replicas and their
generators, a rebuild gathers every replica's positions for the shared
table (bitwise the one-process table), the half-skin trip is a local max
and an ``all_reduce(MAX)``, and checkpoints hold every replica, as one
process writes them.

Resilience (:mod:`repro_torch.resilience`): ``_fault_injector``, when set,
is called at every chunk start on either plan with ``(engine, carry, n)``
and returns the (possibly corrupted) carry; :meth:`Engine.rebind` swaps the
integrator config or the skin at a chunk boundary (the supervisor's dt
ladder); ``evict_slot_hook`` is the serving layer's rung of the
supervisor's ladder.

The ``Sharded`` plan (:mod:`repro_torch.parallel.plan`) runs one trajectory
over a ``torch.distributed`` mesh, one process per rank, each holding its
slab of the cell-major ``(cx, cy, cz, K, ...)`` layout
(:mod:`repro_torch.parallel.domain`) on its own device.  The chunk is the
same Python loop; a step makes one fused halo exchange after the drift
(positions, and spins unless midpoint iterations re-exchange them), the
potential's adjoint round (the reaction fold, or K1 -> q_Fp halo -> K2
with ``use_kernel``) and ONE fused scalar ``all_reduce`` (the energy and
the next step's skin test, read back once).  A rebuild migrates atoms to
their new cells in one fused exchange and counts what a full cell or a
jump past the stencil drops; the run raises ``HealthError(kind=
"overflow")`` at the chunk boundary.  ``Engine.state`` and ``_ff`` are
gathered into the original atom order on every rank at a run's end.  Each
rank draws its noise from its own ``torch.Generator``.  ``Sharded(replicas=
R)`` composes a replica axis with the spatial mesh (which may carry a
``"replica"`` dimension): the carry's blocks gain a leading axis of the
rank's local replicas, each with its own cells, table and generator; one
K1 and one K2 launch serve them all; energies and observables are reduced
over the spatial ranks only, the skin test, health and drop counts over the
whole mesh, so every replica rebuilds together.  ``temperature`` is then
(R,) and ``field`` (R, 3) (or Schedules with per-replica columns), the
trace (C, R) and ``magnetization`` (C, R, 3).  ``restore(directory,
plan=...)`` restores a Sharded checkpoint written on any mesh (elastic
restore, :mod:`repro_torch.ckpt.elastic`) and ``rebind(plan=...)`` re-lays
the plan at a new capacity, grid or mesh; both take one trajectory, as the
reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (latest_step, load_checkpoint,
                                         load_md, save_checkpoint, save_md)
from repro_torch.ensemble.protocol import host_rows
from repro_torch.md.analysis import (RangeGuard, accumulate_spin_grid,
                                     accumulate_spin_profile,
                                     charge_from_grid, helix_pitch,
                                     magnetization, pitch_from_profile,
                                     skyrmion_count, topological_charge)
from repro_torch.md.integrator import (ForceField, IntegratorConfig,
                                       make_fused_step)
from repro_torch.md.neighbor import (NeighborTable, Neighborhood, cell_order,
                                     gather_blocks, make_table_builder,
                                     needs_rebuild, reference_pos, refresh_dr,
                                     reverse_index, shared_blocks)
from repro_torch.md.state import (SpinLatticeState, kinetic_energy,
                                  replicate, unstack_state)
from repro_torch.parallel.domain import (DomainNbh, build_local_table,
                                         local_first_index,
                                         make_domain_evaluator,
                                         make_domain_kernel_evaluator,
                                         migrate_cells, pack_domain)
from repro_torch.parallel.halo import HaloTrace
from repro_torch.parallel.plan import Replicated, Sharded, as_plan
from repro_torch.telemetry import (HealthError, TelemetrySession,
                                   as_telemetry, check_chunk, host_sync,
                                   maybe_trace, phase)
from repro_torch.telemetry.monitor import (nonfinite_count,
                                           occupancy_fraction, slot_signals,
                                           spin_norm_dev)
from repro_torch.utils import units
from repro_torch.utils.device import resolve_device


class FusedCarry(NamedTuple):
    """Loop state of the flat plan."""

    state: SpinLatticeState   # hot (possibly cell-ordered) row order
    ff: ForceField
    table: NeighborTable
    nbh: Neighborhood
    perm: torch.Tensor        # (N,) hot row -> original atom id
    n_rebuilds: int


class ReplicaCarry(NamedTuple):
    """Loop state of the replica plan: ``states`` and ``ffs`` carry a
    leading replica axis; the table and the static blocks of ``nbh``
    (idx/mask/tj, and its transpose) are one copy shared by all replicas,
    ``nbh.dr`` is (R, N, M, 3)."""

    states: SpinLatticeState  # (R, N, ...), box (R, 3), step (R,) array
    ffs: ForceField           # (R,) energies, (R, N, 3) forces / fields
    table: NeighborTable      # shared
    nbh: Neighborhood
    n_rebuilds: int


class DomainCarry(NamedTuple):
    """Loop state of the Sharded plan: this rank's slab of the cell-major
    layout.  ``types == -1`` marks empty slots; ``aid`` carries the
    original atom id through migrations, as ``FusedCarry.perm`` does on
    the flat plan."""

    state: SpinLatticeState   # (cx, cy, cz, K, ...) blocks; box, step
    ff: ForceField            # energy global, forces / fields blocked
    nbh: Any                  # parallel.domain.DomainNbh
    aid: torch.Tensor         # (cx, cy, cz, K) int32, -1 = empty
    r0: torch.Tensor          # (cx, cy, cz, K, 3) positions at the rebuild
    trip: bool                # the next step's skin test, reduced with the
                              # energy at the end of the previous step
    n_rebuilds: int
    n_migrated: int           # atoms that changed cell, all ranks
    n_dropped: np.ndarray     # (ranks,) atoms lost at migrations per rank


class EngineTrace(NamedTuple):
    """Observables, one row per emission (chunk end, or every
    ``obs_every`` steps; a replica plan adds the replica axis after the
    emission axis), and the health signals, one row per chunk."""

    time: np.ndarray
    values: dict[str, np.ndarray]
    health: dict[str, np.ndarray] | None = None


OBSERVABLES = ("energy", "kinetic", "magnetization", "charge",
               "skyrmion_count", "pitch")

def _check_names(names) -> tuple:
    names = tuple(names)
    for n in names:
        if n not in OBSERVABLES:
            raise ValueError(f"unknown observable {n!r}; "
                             f"available: {OBSERVABLES}")
    return names


def make_flat_observe(names, masses, magnetic, diag_grid, pitch_axis=0,
                      pitch_bins=64) -> Callable:
    """Observable pipeline over flat (N, ...) tensors (device tensors out)."""
    names = _check_names(names)

    def observe(state: SpinLatticeState, ff: ForceField) -> dict:
        vals = {}
        if "energy" in names:
            vals["energy"] = ff.energy
        if "kinetic" in names:
            vals["kinetic"] = kinetic_energy(state, masses)
        if "magnetization" in names:
            vals["magnetization"] = magnetization(
                state.spin, mask=magnetic[state.types.long()])
        if "charge" in names or "skyrmion_count" in names:
            q = topological_charge(state.pos, state.spin, state.box,
                                   grid=diag_grid)
            vals["charge"] = q
            vals["skyrmion_count"] = skyrmion_count(q)
        if "pitch" in names:
            vals["pitch"] = helix_pitch(state.pos, state.spin, state.box,
                                        axis=pitch_axis, n_bins=pitch_bins)
        return {k: vals[k] for k in names}

    def scoped(state, ff):
        with phase("observe"):
            return observe(state, ff)

    return scoped


def _slot_kinetic(state: SpinLatticeState, masses) -> torch.Tensor:
    """Lattice kinetic energy of a rank's occupied slots."""
    m = masses[torch.clamp(state.types.long(), min=0)]
    ke = torch.where(state.types[..., None] >= 0,
                     m[..., None] * state.vel ** 2,
                     torch.zeros_like(state.vel))
    return 0.5 * units.MVV2E * torch.sum(ke)


def make_domain_observe(names, masses, magnetic, diag_grid, pitch_axis,
                        pitch_bins, reduce_sum, reduce_fixed) -> Callable:
    """Observable pipeline over cell-blocked (cx, cy, cz, K, ...) tensors:
    each rank's partial sums over its occupied slots are reduced across
    ranks (``reduce_sum``; the binned spin sums as fixed-point parts,
    ``reduce_fixed``) and finished with :mod:`repro_torch.md.analysis`'s
    accumulate/finish splits.  ``ff.energy`` is already global."""
    names = _check_names(names)

    def observe(state: SpinLatticeState, ff: ForceField) -> dict:
        occ = state.types >= 0
        tc = torch.clamp(state.types.long(), min=0)
        vals = {}
        if "energy" in names:
            vals["energy"] = ff.energy
        if "kinetic" in names:
            vals["kinetic"] = reduce_sum(_slot_kinetic(state, masses))
        if "magnetization" in names:
            mag = magnetic[tc] & occ
            msum = reduce_sum(torch.sum(torch.where(
                mag[..., None], state.spin, torch.zeros_like(state.spin))
                .reshape(-1, 3), dim=0))
            mcnt = reduce_sum(torch.sum(mag).reshape(1).to(msum.dtype))
            vals["magnetization"] = msum / torch.clamp(mcnt, min=1.0)
        posf, spinf = state.pos.reshape(-1, 3), state.spin.reshape(-1, 3)
        w = occ.reshape(-1)
        if "charge" in names or "skyrmion_count" in names:
            q = charge_from_grid(accumulate_spin_grid(
                posf, spinf, state.box, grid=diag_grid, weight=w,
                reduce=reduce_fixed), diag_grid)
            vals["charge"] = q
            vals["skyrmion_count"] = skyrmion_count(q)
        if "pitch" in names:
            vals["pitch"] = pitch_from_profile(accumulate_spin_profile(
                posf, spinf, state.box, axis=pitch_axis, n_bins=pitch_bins,
                weight=w, reduce=reduce_fixed), state.box, pitch_axis)
        return {k: vals[k] for k in names}

    def scoped(state, ff):
        with phase("observe"):
            return observe(state, ff)

    return scoped


def _in_phase(name: str, fn: Callable) -> Callable:
    """``fn`` run inside the ``repro.<name>`` range."""
    def scoped(*args, **kw):
        with phase(name):
            return fn(*args, **kw)
    return scoped


def _permute_atoms(state: SpinLatticeState, order) -> SpinLatticeState:
    return state._replace(pos=state.pos[order], vel=state.vel[order],
                          spin=state.spin[order], types=state.types[order])


def _is_schedule(x) -> bool:
    return hasattr(x, "at") and hasattr(x, "times") and hasattr(x, "values")


class _StepValues(NamedTuple):
    """A schedule lowered to one chunk's per-step values: a list of Python
    floats (temperature) or an (n, 3) device tensor (field); on the replica
    plan a list of R-float lists, or (n, R, 3)."""

    rows: Any


def _arg_at(arg, i: int):
    return arg.rows[i] if isinstance(arg, _StepValues) else arg


_UNSET = object()
# the key under which a chunk's fixed-point range bound rides the readback
_RANGE = "_fixed_point_range"


def _replica_ff(ffs: ForceField, r: int) -> ForceField:
    return ForceField(ffs.energy[r], ffs.force[r], ffs.field[r])



@dataclasses.dataclass
class Engine:
    """MD engine: flat or replicated on one device, or sharded over the
    ranks of a mesh (see the module docstring).

    ``state``, ``masses``, ``magnetic`` and the potential's parameters must
    already live on ``device`` (default ``"cuda"``; an engine asked for the
    card on a host without one raises).  ``table``, if given, is the
    initial neighbor table in ``state``'s row order (the shared table on
    the replica plan; the Sharded plan builds its own).  On the Sharded
    plan every rank constructs the engine with the same flat state.
    """

    potential: Any
    cfg: IntegratorConfig
    state: SpinLatticeState
    masses: torch.Tensor               # (n_types,)
    magnetic: torch.Tensor             # (n_types,) bool
    cutoff: float
    plan: Any = None                   # None | "single" | plan object
    temperature: Any = None            # None | K | (R,) K | Schedule
    field: Any = None                  # None | (3,) / (R, 3) T | Schedule
    observables: tuple = ("energy", "kinetic", "magnetization", "charge")
    capacity: int = 64                 # per-atom neighbor capacity M
    skin: float = 0.5
    use_cell_list: bool = False
    cell_capacity: int = 24
    diag_grid: tuple = (32, 32)
    device: Any = "cuda"
    obs_every: int | None = None       # None: chunk ends; k: every k steps
    pitch_axis: int = 0
    pitch_bins: int = 64
    table: NeighborTable | None = None  # in input row order
    per_slot: bool = False             # Replicated only: independent jobs
    trace: EngineTrace | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.plan = as_plan(self.plan)
        self._replica = isinstance(self.plan, Replicated)
        self._sharded = isinstance(self.plan, Sharded)
        self.observables = _check_names(self.observables)
        if self.obs_every is not None and self.obs_every < 1:
            raise ValueError("obs_every must be >= 1")
        if self.per_slot and not self._replica:
            raise ValueError("per_slot=True requires the Replicated plan")
        if not (hasattr(self.potential, "compute") or self._sharded):
            raise ValueError("the engine requires a potential with the "
                             "gather-once .compute() surface")
        for name, t in (("state.pos", self.state.pos),
                        ("masses", self.masses),
                        ("magnetic", self.magnetic)):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}; the engine runs "
                                 f"on {self.device}")
        if self.masses.dtype != self.state.pos.dtype:
            raise ValueError(f"masses are {self.masses.dtype}, the state "
                             f"{self.state.pos.dtype}")
        self._last_ckpt = None      # newest checkpoint written by save()
        self._last_ckpt_step = None  # and its step tag
        self.ckpt_pin = None        # a step save() must never collect
        self.ckpt_step_offset = 0   # added to _step_now() for checkpoint
                                    # tags: a per-slot bucket's slot-0
                                    # clock resets on backfill, so the
                                    # serving packer rebases saves onto its
                                    # monotonic bucket clock
        self.run_tags = {}          # extra run_start header fields (the
                                    # serving layer's bucket id)
        self._fault_injector = None  # resilience hook: (engine, carry, n)
                                     # -> carry at each chunk start
        self.evict_slot_hook = None  # serving hook: (HealthError) -> info
                                     # dict, or None; the supervisor calls
                                     # it to evict one poisoned per-slot job
        self._batch = 0             # replicas in this process's batch
        self._rep0 = 0              # the global index of its first one
        self._rep_ranks = None      # Replicated over ranks: their order
        self._rep_group = None      # and their group (None: the world)
        if self._sharded:
            if self.table is not None:
                raise ValueError("the Sharded plan builds its own per-rank "
                                 "tables; pass no table")
            self._halo = HaloTrace()
            self._setup_domain()
            return
        if self._replica:
            r = self.plan.replicas
            if self.state.pos.dim() == 2:
                self.state = replicate(self.state, r)
            if self.state.pos.shape[0] != r:
                raise ValueError(f"state batch {self.state.pos.shape[0]} "
                                 f"!= plan replicas {r}")
            self.state = self.state._replace(
                step=np.asarray(self.state.step, np.int64).reshape(r))
            self._batch = r
            self._setup_replica()
            if self.plan.devices is not None:
                self.shard_replicas(self.plan.devices)
            return
        self._setup_flat()
        self._init_carry(table=self.table, field_now=self._value_now(
            self._norm_arg(self.field, vec=True), vec=True))

    # ------------------------------------------------------------------
    @property
    def dt(self) -> float:
        return self.cfg.dt

    @property
    def replicas(self) -> int:
        """R on the replica plan, 0 on the flat one."""
        return self.plan.replicas

    @property
    def n_rebuilds(self) -> int:
        return self._carry.n_rebuilds

    @property
    def energy(self):
        """Potential energy [eV]: a float, or (R,) on a replica plan (every
        replica's, on every rank, as of the last sync on a plan split over
        ranks)."""
        if self._replica and self._rep_ranks is None:
            return self._carry.ffs.energy.detach().cpu().numpy()
        if self._replica or (self._sharded and self.replicas):
            return self._ff.energy.detach().cpu().numpy()
        return float(self._carry.ff.energy)

    def _step_now(self) -> int:
        c = getattr(self, "_carry", None)
        if self._replica:    # slot 0's clock (every slot's but per-slot)
            return int((self.state if c is None else c.states).step[0])
        return self.state.step if c is None else c.state.step

    def ckpt_step(self) -> int:
        """The step tag :meth:`save` would use now: the carry's clock plus
        ``ckpt_step_offset``, the unit of ``ckpt_pin`` and of a journal's
        recovery refs."""
        return self._step_now() + int(self.ckpt_step_offset)

    # ------------------------------------------------------------------
    # schedule arguments
    # ------------------------------------------------------------------
    def _norm_arg(self, x, vec: bool):
        """None and Schedules pass through; a constant becomes a Python
        float (temperature) or a (3,) tensor on the device (field) - on the
        replica plan a list of R floats, or an (R, 3) tensor."""
        if x is None:
            return None
        if _is_schedule(x):
            if np.ndim(x.times) != 1 and not self.per_slot:
                raise ValueError("per-slot SlotSchedules need the Replicated "
                                 "plan with per_slot=True")
            return x
        return self._as_step_arg(x, vec)

    def _clock(self, carry=None):
        """Host float32 time [ps] at the carry's step (the input state's
        before there is a carry): one clock, or on a per-slot replica plan
        one per slot (R,)."""
        dt = np.float32(self.cfg.dt)
        if carry is None:
            carry = getattr(self, "_carry", None)
        if not self._replica:
            step = self.state.step if carry is None else carry.state.step
            return np.float32(step) * dt
        steps = np.asarray(self.state.step if carry is None
                           else carry.states.step)
        if self.per_slot:
            return steps.astype(np.float32) * dt
        return np.float32(steps[0]) * dt

    def _as_step_arg(self, rows, vec: bool, lead: tuple = ()):
        """A constant, or host float32 schedule values shaped ``lead`` +
        the value's own (and the replica axis), as the step takes them:
        Python floats (lists of R on the replica plans) for temperatures,
        (..., 3) or (..., R, 3) device tensors for fields.  A process that
        holds only some replicas (a plan split over ranks) takes its own
        columns."""
        r = self.replicas if self._batch else 0
        own = slice(self._rep0, self._rep0 + self._batch)
        if vec:
            dt = self.state.pos.dtype
            if isinstance(rows, torch.Tensor) and rows.device == self.device:
                v = rows.to(dt)
            else:
                with host_sync():    # a blocking copy to the card
                    v = torch.as_tensor(rows, dtype=dt, device=self.device)
            if r:
                v = v.reshape(lead + (-1, 3)).expand(
                    lead + (r, 3))[..., own, :].contiguous()
            return v
        if r:
            rows = np.broadcast_to(np.reshape(rows, lead + (-1,)),
                                   lead + (r,))[..., own]
            return rows.astype(np.float64).tolist()
        return np.asarray(rows, np.float64).tolist()

    def _value_now(self, arg, vec: bool):
        """A schedule's value at the current step (host float32), as the
        step takes it."""
        if not _is_schedule(arg):
            return arg
        t = self._clock()
        v = arg.at(t) if np.ndim(arg.times) == 2 else host_rows(arg, t)
        return self._as_step_arg(v, vec)

    def _chunk_arg(self, arg, carry, n: int, vec: bool):
        """Lower a schedule to this chunk's per-step values: times
        ``t0 + i * dt`` (per slot in per-slot mode) and the rows in numpy
        float32, exactly as the reference; constants pass through."""
        if not _is_schedule(arg):
            return arg
        dt = np.float32(self.cfg.dt)
        t0 = self._clock(carry)
        ivec = np.arange(n, dtype=np.float32) * dt
        t = t0[None, :] + ivec[:, None] if np.ndim(t0) else t0 + ivec
        return _StepValues(self._as_step_arg(host_rows(arg, t), vec, (n,)))

    def _emit_for(self, n: int):
        """In-chunk step offsets to observe after, or None (chunk end)."""
        if self.obs_every is None:
            return None
        return {i for i in range(n) if (i + 1) % self.obs_every == 0}

    # ------------------------------------------------------------------
    def _setup_flat(self):
        """Geometry-static setup: table builder, ordering, step closure."""
        build, n_cells, use_cell = make_table_builder(
            self.state.box, self.cutoff, self.capacity, self.cell_capacity,
            self.skin, self.use_cell_list)
        self._reorder = (self.plan.cell_order
                         if self.plan.cell_order is not None else use_cell)
        self._build, self._n_cells = build, n_cells
        # potentials that sum pair reactions read the table's transpose
        self._reverse = bool(getattr(self.potential, "pair_scatter", True))
        box0 = self.state.box
        self._step = make_fused_step(
            gather=_in_phase("refresh",
                             lambda pos, nbh: refresh_dr(nbh, pos, box0)),
            compute=self._compute_ff, cfg=self.cfg, masses=self.masses,
            magnetic=self.magnetic)
        self._observe = make_flat_observe(
            self.observables, self.masses, self.magnetic, self.diag_grid,
            self.pitch_axis, self.pitch_bins)

    def _compute_ff(self, nbh, spin, types, field) -> ForceField:
        with phase("force"):
            return ForceField(*self.potential.compute(nbh, spin, types,
                                                      field))

    def _gather(self, state: SpinLatticeState, table) -> Neighborhood:
        return gather_blocks(state.pos, state.types, table, state.box,
                             reverse=self._reverse)

    def _rebuild(self, state, perm, field):
        """(Re)order atoms, rebuild the table, gather, evaluate."""
        with phase("rebuild"):
            if self._reorder:
                order = cell_order(state.pos, state.box, self._n_cells)
                state = _permute_atoms(state, order)
                perm = perm[order]
            table = self._build(state.pos, state.box)
            nbh = self._gather(state, table)
        ff = self._compute_ff(nbh, state.spin, state.types, field)
        return state, ff, table, nbh, perm

    def _init_carry(self, table: NeighborTable | None = None,
                    field_now=None):
        """(Re)build the hot carry from ``self.state`` at the given field
        (with ``table``, a caller's table in input row order, as is); the
        rebuild count is cumulative across restarts."""
        perm0 = torch.arange(self.state.pos.shape[0], device=self.device)
        count0 = (self._carry.n_rebuilds
                  if getattr(self, "_carry", None) is not None else 0)
        if table is not None:
            nbh = self._gather(self.state, table)
            ff = self._compute_ff(nbh, self.state.spin, self.state.types,
                                  field_now)
            self._carry = FusedCarry(self.state, ff, table, nbh, perm0,
                                     count0)
        else:
            st, ff, tab, nbh, perm = self._rebuild(self.state, perm0,
                                                   field_now)
            self._carry = FusedCarry(st, ff, tab, nbh, perm, count0)
        self._sync_flat()

    def _sync_flat(self):
        """Map the hot (cell-ordered) carry back to the original atom order:
        ``state``, forces and ``table`` all come back in input order."""
        c = self._carry
        inv = torch.argsort(c.perm)
        self.state = _permute_atoms(c.state, inv)
        self._ff = ForceField(energy=c.ff.energy, force=c.ff.force[inv],
                              field=c.ff.field[inv])
        if self._reorder:
            self.table = NeighborTable(
                idx=c.perm[c.table.idx[inv].long()].to(torch.int32),
                mask=c.table.mask[inv], r0=c.table.r0[inv],
                cutoff=c.table.cutoff)
        else:
            self.table = c.table
        self._obs_state = self.state

    def _restart_if_swapped(self, farg):
        """Honor a caller-swapped ``engine.state``: same box restarts the
        carry, a new box re-derives the geometry."""
        if self.state is self._obs_state:
            return
        if not torch.equal(self.state.box, self._carry.state.box):
            self._setup_flat()
        self._init_carry(field_now=self._value_now(farg, vec=True))

    # ==================================================================
    # the replica plan
    # ==================================================================
    def _setup_replica(self):
        """Shared-table replica batch: builder, step closure, the initial
        table, blocks and forces (no cell reordering: one table serves
        every replica).  ``self.state`` holds every replica; on a plan
        split over ranks the carry keeps this rank's."""
        full = self.state
        st = self._own_rows(full)
        self._box0, self._types0 = st.box[0], st.types[0]
        build, _, _ = make_table_builder(
            self._box0, self.cutoff, self.capacity, self.cell_capacity,
            self.skin, self.use_cell_list)
        self._build = build
        self._reverse = bool(getattr(self.potential, "pair_scatter", True))
        box0 = self._box0
        self._step = make_fused_step(
            gather=_in_phase("refresh",
                             lambda pos, nbh: refresh_dr(nbh, pos, box0)),
            compute=self._replica_eval, cfg=self.cfg, masses=self.masses,
            magnetic=self.magnetic)
        self._observe = make_flat_observe(
            self.observables, self.masses, self.magnetic, self.diag_grid,
            self.pitch_axis, self.pitch_bins)
        f0 = self._value_now(self._norm_arg(self.field, vec=True), vec=True)
        if self.table is not None:
            table = self.table
        else:
            with phase("rebuild"):
                table = build(reference_pos(full.pos, box0), box0)
        nbh = self._shared(table, st.pos)
        self._carry = ReplicaCarry(st, self._replica_eval(nbh, st.spin, None,
                                                          f0),
                                   table, nbh, 0)
        self._sync_replica()

    def _shared(self, table, pos) -> Neighborhood:
        return shared_blocks(table, self._types0, pos, self._box0,
                             reverse=self._reverse)

    def _replica_eval(self, nbh, spin, types, field) -> ForceField:
        """THE evaluation of the replica plan - the step, rebuilds, the
        initial forces, resync and :meth:`write_slots` all call it, so a
        slot's forces never depend on which of them made them.  ``types``
        is ignored: replicas share the table's types."""
        with phase("force"):
            return ForceField(*self.potential.compute(nbh, spin, self._types0,
                                                      field))

    def _replica_rebuild(self, states, field):
        """A shared table from the replica-mean positions, every replica's
        ``dr``, forces.  Split over ranks, the positions of every replica
        are gathered first (an ``all_gather``, not a sum over ranks), so
        the mean is taken in the one-process order and the table is the
        one-process table bit for bit."""
        with phase("rebuild"):
            table = self._build(reference_pos(self._rep_all(states.pos),
                                              self._box0), self._box0)
            nbh = self._shared(table, states.pos)
        return table, nbh, self._replica_eval(nbh, states.spin, None, field)

    def _sync_replica(self):
        """``state`` and ``_ff`` as the carry has them - every replica's,
        gathered from the ranks on a plan split over them."""
        c = self._carry
        self.state, self._ff = self._full_batch(c)
        self.table = c.table
        self._obs_state = self.state

    def _full_batch(self, c: ReplicaCarry):
        """(states, forces) of every replica: the carry's own, or gathered
        from the ranks of a plan split over them."""
        if self._rep_ranks is None:
            return c.states, c.ffs
        st = c.states
        steps = self._rep_all(torch.as_tensor(np.asarray(st.step),
                                              device=self.device))
        with host_sync():
            steps = steps.cpu().numpy()
        return (SpinLatticeState(
            *(self._rep_all(getattr(st, k))
              for k in ("pos", "vel", "spin", "types", "box")),
            step=steps),
            ForceField(*(self._rep_all(x) for x in c.ffs)))

    # -- the replica axis split over ranks ------------------------------
    def _own_rows(self, states: SpinLatticeState) -> SpinLatticeState:
        """This rank's replicas of a batch of every replica (the batch
        itself on one process)."""
        if self._rep_ranks is None or states.pos.shape[0] == self._batch:
            return states
        own = slice(self._rep0, self._rep0 + self._batch)
        return SpinLatticeState(
            *(getattr(states, k)[own]
              for k in ("pos", "vel", "spin", "types", "box")),
            step=np.asarray(states.step)[own])

    def _rep_all(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's replicas of ``t`` (this rank's along ``dim``),
        concatenated in replica order: an ``all_gather`` over the replica
        ranks; ``t`` itself on one process."""
        if self._rep_ranks is None:
            return t
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in self._rep_ranks]
        dist.all_gather(parts, t, group=self._rep_group)
        order = sorted(self._rep_ranks)    # a group's ranks, ascending
        return torch.cat([parts[order.index(r)] for r in self._rep_ranks],
                         dim=dim)

    def _rep_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced (``"sum"`` or ``"max"``) over the replica ranks."""
        if self._rep_ranks is None:
            return t
        import torch.distributed as dist
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self._rep_group)
        return out

    def _replica_restart_if_swapped(self, farg):
        """Resync only when the caller swapped ``engine.state``: an
        untouched carry flows through as it is, so a resumed run stays
        bitwise."""
        if self.state is not self._obs_state:
            self._replica_resync(farg)

    def _replica_resync(self, farg):
        """Take ``engine.state`` as the batch (moves below half the skin
        never trip a rebuild), refresh every ``dr`` against the shared
        table and re-evaluate at the schedule's current field."""
        if not torch.equal(self.state.box[0], self._box0):
            raise ValueError("the replica plan keeps its box; build a new "
                             "Engine for a new geometry")
        st = self._own_rows(self.state._replace(
            step=np.asarray(self.state.step, np.int64).reshape(-1)))
        c = self._carry
        nbh = refresh_dr(c.nbh, st.pos, self._box0)
        ffs = self._replica_eval(nbh, st.spin, None,
                                 self._value_now(farg, vec=True))
        self._carry = c._replace(states=st, nbh=nbh, ffs=ffs)
        self._sync_replica()

    def shard_replicas(self, devices=None) -> "Engine":
        """Split the replica axis over the ranks ``devices`` names (a
        ``DeviceMesh`` or a sequence of ranks of the default group, in
        replica order): each holds R / ranks replicas, their generators,
        forces and ``dr`` rows, and the shared table.  A no-op for one
        rank (or None).

        Every rank of the world calls it (a group over part of the world
        is a collective).  Then a rebuild gathers every replica's positions
        (the table is the one-process table), the half-skin trip is a local
        max and an ``all_reduce(MAX)``, observables and health are
        gathered, and ``run`` takes this rank's R / ranks generators.
        ``state`` and ``_ff`` hold every replica on every rank after a
        sync."""
        if not self._replica:
            raise ValueError("shard_replicas requires the Replicated plan")
        from repro_torch.parallel.plan import replica_ranks
        ranks = replica_ranks(devices)
        if ranks is None or len(ranks) <= 1:
            return self
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("splitting replicas over ranks needs an "
                             "initialised process group")
        if self.per_slot:
            raise ValueError("a per-slot batch (serving) stays on one "
                             "process")
        r = self.plan.replicas
        if r % len(ranks):
            raise ValueError(f"{r} replicas not divisible by {len(ranks)} "
                             "ranks")
        world = dist.get_world_size()
        group = (None if sorted(ranks) == list(range(world))
                 else dist.new_group(ranks=sorted(ranks)))
        me = dist.get_rank()
        if me not in ranks:
            raise ValueError(f"rank {me} holds none of the replicas (ranks "
                             f"{list(ranks)})")
        self._sync_replica()                 # every replica, before the split
        full = self.state
        self._rep_ranks, self._rep_group = tuple(ranks), group
        self._batch = r // len(ranks)
        self._rep0 = ranks.index(me) * self._batch
        own = slice(self._rep0, self._rep0 + self._batch)
        c = self._carry
        self._carry = c._replace(
            states=self._own_rows(full),
            ffs=ForceField(*(x[own] for x in c.ffs)),
            nbh=c.nbh._replace(dr=c.nbh.dr[own].contiguous()))
        self._sync_replica()
        return self

    def write_slots(self, slots, states: SpinLatticeState, *,
                    field=_UNSET) -> None:
        """Seat new jobs in replica ``slots`` between chunks (the serving
        layer's backfill).

        ``states`` is the matching (k, N, ...) batch
        (:func:`~repro_torch.md.state.stack_states`).  Only the named slots
        change: their rows go into the carry, their ``dr`` is refreshed
        against the existing shared table (no rebuild) and their forces are
        evaluated by the plan's one evaluation routine at ``field`` (default
        the engine's) on each slot's own clock.  The other slots keep their
        bits.  Swap the slot's generator in the list passed to the next
        :meth:`run`."""
        if not self._replica:
            raise ValueError("write_slots requires the Replicated plan")
        if self._rep_ranks is not None:
            raise ValueError("write_slots takes a batch on one process")
        idx = [int(i) for i in slots]
        if not idx:
            raise ValueError("slots must be a non-empty index sequence")
        c = self._carry
        ix = torch.as_tensor(idx, device=self.device)

        def put(cur, rows):
            out = cur.clone()
            out[ix] = rows.to(device=cur.device, dtype=cur.dtype)
            return out

        steps = np.asarray(c.states.step, np.int64).copy()
        steps[idx] = np.asarray(states.step, np.int64).reshape(-1)
        new = SpinLatticeState(
            *(put(getattr(c.states, k), getattr(states, k))
              for k in ("pos", "vel", "spin", "types", "box")), step=steps)
        dr_rows = refresh_dr(c.nbh, new.pos[ix], self._box0).dr
        farg = self._norm_arg(self.field if field is _UNSET else field,
                              vec=True)
        if _is_schedule(farg):
            t = steps[idx].astype(np.float32) * np.float32(self.cfg.dt)
            v = (type(farg)(times=farg.times[idx], values=farg.values[idx])
                 .at(t) if np.ndim(farg.times) == 2 else host_rows(farg, t))
            f_rows = torch.as_tensor(v, dtype=new.pos.dtype,
                                     device=self.device).reshape(-1, 3)
            f_rows = f_rows.expand(len(idx), 3).contiguous()
        else:
            f_rows = None if farg is None else farg[ix]
        rows = self._replica_eval(c.nbh._replace(dr=dr_rows), new.spin[ix],
                                  None, f_rows)
        ffs = ForceField(*(put(cur, row) for cur, row in zip(c.ffs, rows)))
        self._carry = c._replace(states=new, ffs=ffs,
                                 nbh=c.nbh._replace(dr=put(c.nbh.dr,
                                                           dr_rows)))
        self._sync_replica()

    def _replica_kinetic(self, states) -> torch.Tensor:
        """Each replica's lattice kinetic energy (R,)."""
        return torch.stack([kinetic_energy(unstack_state(states, r),
                                           self.masses)
                            for r in range(states.pos.shape[0])])

    def _replica_observe(self, states, ffs) -> dict:
        """The flat observables of every replica of this process's batch,
        stacked: {name: (R, ...)}."""
        rows = [self._observe(unstack_state(states, r), _replica_ff(ffs, r))
                for r in range(states.pos.shape[0])]
        return {k: torch.stack([row[k] for row in rows]) for k in rows[0]}

    def _replica_chunk(self, carry: ReplicaCarry, generator, targ, farg,
                       n: int, emit):
        """``n`` steps of every replica; as :meth:`_chunk`."""
        etot0 = carry.ffs.energy + self._replica_kinetic(carry.states)
        box0 = self._box0
        rows = []
        for i in range(n):
            with phase("step"):
                temp, field = _arg_at(targ, i), _arg_at(farg, i)
                # any replica past half the skin rebuilds the shared table
                with phase("skin_test"):
                    trip = self._rep_reduce(needs_rebuild(
                        carry.table, carry.states.pos, box0,
                        self.skin).to(torch.int32), "max")
                    with host_sync():
                        trip = trip.item()
                if trip:
                    table, nbh, ffs = self._replica_rebuild(carry.states,
                                                            field)
                    carry = ReplicaCarry(carry.states, ffs, table, nbh,
                                         carry.n_rebuilds + 1)
                with phase("integrate"):
                    st, ffs, nbh = self._step(carry.states, carry.ffs,
                                              carry.nbh, generator, temp,
                                              field)
                carry = carry._replace(states=st, ffs=ffs, nbh=nbh)
                if emit is not None and i in emit:
                    rows.append(self._replica_observe(st, ffs))
        if emit is None:
            rows.append(self._replica_observe(carry.states, carry.ffs))
        if rows:
            obs = {k: torch.stack([r[k] for r in rows])
                   for k in self.observables}
        else:
            obs = {k: v[None][:0] for k, v in self._replica_observe(
                carry.states, carry.ffs).items()}
        obs = {k: self._rep_all(v, dim=1) for k, v in obs.items()}
        return carry, obs, self._replica_health(carry, etot0)

    def _replica_health(self, c: ReplicaCarry, etot0) -> dict:
        """The health signals (:mod:`repro_torch.telemetry.monitor`) over
        the batch - ``e_drift`` is the signed drift of the replica with the
        largest magnitude - and in per-slot mode the per-slot vectors of
        :func:`~repro_torch.telemetry.monitor.slot_signals`."""
        st, ffs = c.states, c.ffs
        drift = self._rep_all(ffs.energy + self._replica_kinetic(st)
                              - etot0)
        mag = self.magnetic[st.types.long()]
        h = {"e_drift": drift[torch.argmax(torch.abs(drift))],
             "spin_dev": self._rep_reduce(spin_norm_dev(st.spin, mag),
                                          "max"),
             "nonfinite": self._rep_reduce(
                 nonfinite_count(st.pos, ffs.force, st.spin), "sum"),
             "nbr_occ": occupancy_fraction(c.table.mask)}
        if self.per_slot:
            h.update(slot_signals(st.pos, ffs.force, st.spin, mag, drift))
        return h

    # ==================================================================
    # the Sharded plan
    # ==================================================================
    def _setup_domain(self):
        """Resolve the plan against the state, bin it into the cell grid,
        build this rank's step closure, table and forces.  With replicas
        every local replica starts from the same binned state."""
        pot = self.potential
        self._use_kernel = bool(getattr(pot, "use_kernel", False))
        if not (hasattr(pot, "pair_energies") or self._use_kernel):
            raise ValueError("the Sharded plan needs a potential with the "
                             "pair_energies/site_moments surface (or the "
                             "NEP kernels, use_kernel=True)")
        if self._use_kernel and self.cfg.midpoint:
            raise ValueError("the kernel-routed Sharded evaluator computes "
                             "forces through the q_Fp adjoint exchange and "
                             "does not support self-consistent midpoint "
                             "configs")
        if self.state.pos.dim() != 2:
            raise ValueError("the Sharded plan takes one flat (N, ...) state")
        rp = self.plan.resolve(self.state.box, self.state.pos, self.cutoff,
                               self.skin,
                               self.state.pos.dtype == torch.float32)
        self._rplan = rp
        self._batch, self._rep0 = rp.local_replicas(), rp.replica_offset()
        self._n_atoms = n = self.state.pos.shape[0]
        packed, extras = pack_domain(
            rp.dspec, self.state.pos, self.state.vel, self.state.spin,
            self.state.types, extras={"aid": np.arange(n, dtype=np.int32)})
        self._build_domain_step()
        blk = self._local_block
        start = SpinLatticeState(
            pos=blk(packed.pos), vel=blk(packed.vel), spin=blk(packed.spin),
            types=blk(packed.types), box=self.state.box,
            step=int(self.state.step))
        field = self._value_now(self._norm_arg(self.field, vec=True),
                                vec=True)
        count0 = (self._carry.n_rebuilds
                  if getattr(self, "_carry", None) is not None else 0)
        with self._halo:
            st, ff, nbh, aid, moved, dropped = self._domain_rebuild(
                start, blk(extras["aid"]), field)
            _, dropped = self._count_rebuild(moved, dropped)
            ff = ff._replace(energy=self._reduce_spatial(ff.energy))
        self._carry = DomainCarry(st, ff, nbh, aid, st.pos, False, count0, 0,
                                  dropped)
        self._check_dropped()
        self._sync_domain()

    def _local_block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a global (CX, CY, CZ, ...) host grid, on the
        engine's device - one copy per local replica with replicas."""
        rp = self._rplan
        sl = tuple(slice(o, o + c) for o, c in zip(rp.offsets,
                                                   rp.local_shape))
        t = t[sl].to(self.device)
        if self._batch:
            t = t[None].expand((self._batch,) + tuple(t.shape))
        return t.contiguous()

    def _build_domain_step(self):
        rp = self._rplan
        dspec, local, axes, ag = rp.dspec, rp.local_shape, rp.axes, \
            rp.allgather
        # midpoint iterations evaluate at updated spins, so they exchange
        # spin ghosts per evaluation; otherwise one fused (pos, spin)
        # exchange per drift and one adjoint round per evaluation.  The
        # reference builds these evaluators with ``barrier=not replicas``:
        # its issue-early barrier (interior work scheduled while the halo
        # is in flight) has no vmap rule.  Here that overlap is the
        # asynchronous exchange with the interior slab gathered from the
        # local wrap (parallel/domain.py:_gather_blocks); local replicas
        # ride one message and keep it, so nothing is switched off.
        sig = self._spin_in_gather = not self.cfg.midpoint
        if self._use_kernel:
            refresh, compute = make_domain_kernel_evaluator(
                self.potential, dspec, axes, local, allgather=ag)
            self._ext_to_lf = local_first_index(local, dspec.capacity,
                                                self.device)[0]
        else:
            refresh, compute = make_domain_evaluator(
                self.potential, dspec, axes, local, spin_in_gather=sig,
                allgather=ag)
        self._domain_refresh, self._domain_compute = refresh, compute
        self._step = make_fused_step(
            gather=_in_phase("refresh", (
                lambda pos, nbh, spin: refresh(pos, nbh, spin,
                                               tag="drift-pos"))
                if sig else (lambda pos, nbh: refresh(pos, nbh,
                                                      tag="drift-pos"))),
            compute=self._domain_ff, cfg=self.cfg, masses=self.masses,
            magnetic=self.magnetic, atom_mask="from_types",
            spin_aware_gather=sig)
        self._observe = make_domain_observe(
            self.observables, self.masses, self.magnetic, self.diag_grid,
            self.pitch_axis, self.pitch_bins, self._reduce_spatial,
            self._reduce_fixed)

    def _domain_ff(self, nbh, spin, types, field) -> ForceField:
        """One evaluation on this rank's slots (energy rank-local)."""
        with phase("force"):
            return ForceField(*self._domain_compute(nbh, spin, types, field))

    def _reduce_sum(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """``t`` reduced over every rank of the mesh into a new tensor (a
        sum unless ``op``); ``t`` itself on one rank."""
        if self._rplan.world == 1:
            return t
        import torch.distributed as dist
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                        group=self._rplan.groups.mesh)
        return out

    def _reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        return self._reduce_sum(t, op=dist.ReduceOp.MAX)

    def _reduce_spatial(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks of this rank's spatial decomposition
        (the whole mesh without a replica dimension; otherwise each
        spatial dimension's group in turn, as the reference's psums)."""
        spatial = self._rplan.groups.spatial
        if spatial is None:
            return self._reduce_sum(t)
        import torch.distributed as dist
        out = t.detach().clone()
        for group in spatial:
            if dist.get_world_size(group) > 1:
                dist.all_reduce(out, group=group)
        return out

    def _reduce_fixed(self, acc, bound, bad):
        """The fixed-point parts of a binned sum, added over the spatial
        ranks before the range check
        (:func:`repro_torch.md.analysis.segment_sum`)."""
        return tuple(self._reduce_spatial(t) for t in (acc, bound, bad))

    def _gather_mesh(self, t: torch.Tensor) -> list:
        """Every mesh rank's ``t``, by linear mesh index."""
        rp = self._rplan
        if rp.world == 1:
            return [t]
        import torch.distributed as dist
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(rp.world)]
        group = rp.groups.mesh
        dist.all_gather(parts, t, group=group)
        order = (sorted(rp.groups.ranks) if group is not None
                 else list(range(rp.world)))
        return [parts[order.index(r)] for r in rp.groups.ranks]

    def _gather_replicas(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's replicas of ``t`` (leading axis, reduced over the
        spatial ranks already) -> every replica's (R, ...)."""
        rp = self._rplan
        if not rp.rep_in_mesh():
            return t
        out = [None] * self.replicas
        for i, part in enumerate(self._gather_mesh(t)):
            off = rp.replica_offset_of(i)
            for j in range(self._batch):
                out[off + j] = part[j]
        return torch.stack(out)

    def _domain_tables(self, pos, spin, idx, mask, tj, tag: str):
        """A rebuilt table's blocks: its transpose over the ext-flat rows
        (autograd; one per local replica) or its local-first renumbering
        (kernels), then the fused refresh of ``dr`` (and ``sj``)."""
        m = idx.shape[-1]
        lead = idx.shape[:idx.dim() - 5]
        rev = lf = None
        if self._use_kernel:
            lf = self._ext_to_lf[idx.reshape(lead + (-1, m)).long()].to(
                torch.int32)
        else:
            cx, cy, cz = self._rplan.local_shape
            n_ext = (cx + 2) * (cy + 2) * (cz + 2) * idx.shape[-2]
            rev = reverse_index(idx.reshape(-1, m), n_rows=n_ext) \
                if not lead else tuple(
                    reverse_index(x.reshape(-1, m), n_rows=n_ext)
                    for x in idx)
        nbh = DomainNbh(idx=idx, mask=mask, tj=tj, dr=None, rev=rev, lf=lf)
        return self._domain_refresh(pos, nbh,
                                    spin if self._spin_in_gather else None,
                                    tag=tag)

    def _domain_rebuild(self, state, aid, field):
        """Migrate atoms to their cells, rebuild the table, refresh the
        blocks and evaluate (every local replica, each its own cells and
        table); the counts come back rank-local."""
        rp = self._rplan
        with phase("rebuild"):
            pos, vel, spin, types, aid, moved, dropped = migrate_cells(
                rp.dspec, rp.axes, rp.local_shape, rp.offsets, state.pos,
                state.vel, state.spin, state.types, aid,
                allgather=rp.allgather)
            idx, mask, tj = build_local_table(
                rp.dspec, rp.axes, rp.local_shape, self.capacity, pos, types,
                allgather=rp.allgather)
            nbh = self._domain_tables(pos, spin, idx, mask, tj, "rebuild-pos")
            state = state._replace(pos=pos, vel=vel, spin=spin, types=types)
        ff = self._domain_ff(nbh, spin, types, field)
        return state, ff, nbh, aid, moved, dropped

    def _count_rebuild(self, moved, dropped):
        """One reduction a rebuild: ``(atoms moved on every rank, (ranks,)
        per-rank drop counts)`` on the host."""
        rp = self._rplan
        vec = torch.zeros(1 + rp.world, dtype=torch.int64,
                          device=moved.device)
        vec[0] = moved
        vec[1 + rp.rank] = dropped
        vec = self._reduce_sum(vec)
        with host_sync():
            vec = vec.cpu().numpy()
        return int(vec[0]), vec[1:]

    def _trip_local(self, state, r0) -> torch.Tensor:
        """Did an atom of this rank (of any local replica) move past half
        the skin since the rebuild?"""
        d = state.pos - r0
        d = d - state.box * torch.round(d / state.box)
        d2 = torch.sum(d * d, dim=-1)
        d2 = torch.where(state.types >= 0, d2, torch.zeros_like(d2))
        return torch.max(d2) > (self.skin * 0.5) ** 2

    def _domain_kinetic(self, state) -> torch.Tensor:
        """Lattice kinetic energy of this rank's slots: a 0-d tensor, or
        (R,) per local replica."""
        if not self._batch:
            return _slot_kinetic(state, self.masses)
        return torch.stack([_slot_kinetic(self._replica_slab(state, r),
                                          self.masses)
                            for r in range(self._batch)])

    @staticmethod
    def _replica_slab(state: SpinLatticeState, r: int) -> SpinLatticeState:
        return state._replace(pos=state.pos[r], vel=state.vel[r],
                              spin=state.spin[r], types=state.types[r])

    def _domain_observe(self, state, ff) -> dict:
        """The observables of this rank's replicas: reduced over the
        spatial ranks, then (replicas on the mesh) gathered, (R, ...)."""
        if not self._batch:
            return self._observe(state, ff)
        rows = [self._observe(self._replica_slab(state, r),
                              ff._replace(energy=ff.energy[r]))
                for r in range(self._batch)]
        return {k: self._gather_replicas(torch.stack([row[k]
                                                      for row in rows]))
                for k in rows[0]}

    def _domain_chunk(self, carry: DomainCarry, generator, targ, farg,
                      n: int, emit):
        """``n`` steps of this rank's slab; as :meth:`_chunk`."""
        etot0 = carry.ff.energy + self._reduce_spatial(
            self._domain_kinetic(carry.state))
        rows = []
        for i in range(n):
            with phase("step"):
                carry = self._domain_step(carry, generator,
                                          _arg_at(targ, i), _arg_at(farg, i))
                if emit is not None and i in emit:
                    rows.append(self._domain_observe(carry.state, carry.ff))
        if emit is None:
            rows.append(self._domain_observe(carry.state, carry.ff))
        if rows:
            obs = {k: torch.stack([r[k] for r in rows])
                   for k in self.observables}
        else:
            obs = {k: v[None][:0] for k, v in
                   self._domain_observe(carry.state, carry.ff).items()}
        return carry, obs, self._domain_health(carry, etot0)

    def _domain_step(self, carry: DomainCarry, generator, temp,
                     field) -> DomainCarry:
        """One step of this rank's slab: the rebuild the last step's skin
        test asked for, the step, and the next skin test."""
        if carry.trip:
            st, ff, nbh, aid, moved, dropped = self._domain_rebuild(
                carry.state, carry.aid, field)
            moved, dropped = self._count_rebuild(moved, dropped)
            carry = DomainCarry(st, ff, nbh, aid, st.pos, False,
                                carry.n_rebuilds + 1,
                                carry.n_migrated + moved,
                                carry.n_dropped + dropped)
        with phase("integrate"):
            st, ff, nbh = self._step(carry.state, carry.ff, carry.nbh,
                                     generator, temp, field)
        with phase("skin_test"):
            e = ff.energy
            trip = self._trip_local(st, carry.r0).to(e.dtype)
            if not self._batch:
                # ONE fused scalar reduction a step: the global energy and
                # the next step's skin test, read back once (module
                # docstring)
                vec = self._reduce_sum(torch.stack([e, trip]))
                energy, trip = vec[0], vec[1]
            else:
                # replicas: energies over the spatial ranks; the skin test
                # over the whole mesh, so every replica rebuilds together
                vec = self._reduce_spatial(torch.cat([e, trip[None]]))
                energy, trip = vec[:-1], vec[-1]
                if self._rplan.rep_in_mesh():
                    trip = self._reduce_max(trip)
            with host_sync():
                trip = bool(trip > 0)
        return carry._replace(state=st, ff=ff._replace(energy=energy),
                              nbh=nbh, trip=trip)

    def _domain_health(self, c: DomainCarry, etot0) -> dict:
        """The health signals, global over the mesh (plus ``cell_occ``, the
        fullest cell's share of K); with replicas ``e_drift`` is the signed
        drift of the replica with the largest magnitude."""
        st, ff = c.state, c.ff
        occ = st.types >= 0
        dt = st.pos.dtype
        mag = self.magnetic[torch.clamp(st.types.long(), min=0)] & occ
        cell_occ = torch.max(torch.sum(occ, dim=-1)) / float(occ.shape[-1])
        maxes = self._reduce_max(torch.stack(
            [spin_norm_dev(st.spin, mag).to(dt),
             occupancy_fraction(c.nbh.mask).to(dt), cell_occ.to(dt)]))
        if not self._batch:
            sums = self._reduce_sum(torch.stack(
                [_slot_kinetic(st, self.masses),
                 nonfinite_count(st.pos, ff.force, st.spin).to(dt)]))
            drift, bad = ff.energy + sums[0] - etot0, sums[1]
        else:
            drift = self._gather_replicas(
                ff.energy + self._reduce_spatial(self._domain_kinetic(st))
                - etot0)
            drift = drift[torch.argmax(torch.abs(drift))]
            bad = self._reduce_sum(
                nonfinite_count(st.pos, ff.force, st.spin).to(dt))
        return {"e_drift": drift, "spin_dev": maxes[0], "nonfinite": bad,
                "nbr_occ": maxes[1], "cell_occ": maxes[2]}

    def _check_dropped(self, chunk_index: int | None = None):
        """Raise a ``HealthError(kind="overflow")`` when a migration dropped
        atoms, with the per-rank counts and the last-good checkpoint."""
        vec = np.atleast_1d(np.asarray(self._carry.n_dropped))
        dropped = int(vec.sum())
        if dropped:
            per_rank = {int(i): int(v) for i, v in enumerate(vec) if v}
            raise HealthError(
                f"domain cell overflow: {dropped} atom(s) dropped at "
                f"migration (cell capacity {self._rplan.dspec.capacity} "
                "exceeded or an atom jumped more than one cell between "
                "rebuilds); increase cell_capacity or shrink the "
                f"skin/timestep; per-rank drop counts: {per_rank}",
                step=self._step_now(), chunk_index=chunk_index,
                signals={"dropped": dropped, "dropped_per_device": per_rank},
                checkpoint_path=self._last_ckpt, kind="overflow")

    @property
    def n_migrated(self) -> int:
        """Atoms that changed link cell across all rebuilds (Sharded)."""
        return int(self._carry.n_migrated)

    @property
    def halo_ledger(self) -> HaloTrace:
        """This engine's halo exchange ledger (Sharded): counts and bytes
        per tag over every exchange since construction."""
        return self._halo

    def _sync_domain(self):
        """Gather every rank's slots and restore the original atom order:
        ``state`` and ``_ff`` as the flat plan has them (with replicas as
        the Replicated plan has them, (R, N, ...)), on every rank."""
        c = self._carry
        rp = self._rplan
        dt = c.state.pos.dtype
        cols = [c.state.pos, c.state.vel, c.state.spin, c.ff.force,
                c.ff.field, c.state.types[..., None], c.aid[..., None]]
        lead = (self._batch,) if self._batch else ()
        buf = torch.cat([x.reshape(lead + (-1, x.shape[-1])).to(dt)
                         for x in cols], dim=-1)
        parts = self._gather_mesh(buf)
        if not self._batch:
            rows = self._unbin_rows(torch.cat(parts))
            energy = c.ff.energy
        else:
            per = [[] for _ in range(self.replicas)]
            for i, part in enumerate(parts):
                off = rp.replica_offset_of(i)
                for j in range(self._batch):
                    per[off + j].append(part[j])
            rows = torch.stack([self._unbin_rows(torch.cat(p)) for p in per])
            energy = self._gather_replicas(c.ff.energy)
        col = lambda lo: rows[..., lo:lo + 3].contiguous()
        self.state = SpinLatticeState(
            pos=col(0), vel=col(3), spin=col(6),
            types=torch.round(rows[..., 15]).to(torch.int32),
            box=c.state.box, step=c.state.step)
        self._ff = ForceField(energy=energy, force=col(9), field=col(12))
        self._obs_state = self.state

    def _unbin_rows(self, buf: torch.Tensor) -> torch.Tensor:
        """The rows of a gathered (slots, 17) buffer in original atom order
        (its column 16 holds the atom id, -1 for an empty slot)."""
        aid = torch.round(buf[:, 16]).long()
        with host_sync():
            sel = torch.nonzero(aid >= 0).reshape(-1)
        order = torch.empty(self._n_atoms, dtype=torch.int64,
                            device=buf.device)
        order[aid[sel]] = sel
        return buf[order]

    def _domain_ckpt_tree(self, c: DomainCarry) -> dict:
        """What a rank's shard holds: the carry without the position-
        dependent blocks, which restore re-derives from the table and
        positions."""
        return {"state": c.state, "ff": c.ff, "aid": c.aid, "r0": c.r0,
                "idx": c.nbh.idx, "mask": c.nbh.mask, "tj": c.nbh.tj,
                "trip": c.trip, "n_rebuilds": c.n_rebuilds,
                "n_migrated": c.n_migrated, "n_dropped": c.n_dropped}

    def _domain_layout(self) -> np.ndarray:
        """(ranks, cells, K, local cells, replicas) of this engine's plan:
        a checkpoint manifest's layout."""
        rp = self._rplan
        return np.asarray([rp.world, *rp.dspec.cells, rp.dspec.capacity,
                           *rp.local_shape, rp.replicas], np.int64)

    def _domain_save(self, directory: str, generator, keep: int) -> str:
        """Each rank writes its shard and generator state(s) under
        ``rank_<r>/`` (r its linear mesh index); after every rank has, the
        first writes the step's manifest (the layout), which marks the
        checkpoint complete."""
        rp = self._rplan
        step = self.ckpt_step()
        save_md(os.path.join(directory, f"rank_{rp.rank:05d}"), step,
                self._domain_ckpt_tree(self._carry), generator, keep=keep,
                pin=self.ckpt_pin)
        barrier = rp.world > 1
        if barrier:
            import torch.distributed as dist
            dist.barrier(group=rp.groups.mesh)
        path = os.path.join(directory, f"step_{step:09d}")
        if rp.rank == 0:
            path = save_checkpoint(directory, step,
                                   {"layout": self._domain_layout()},
                                   keep=keep, pin=self.ckpt_pin)
        if barrier:
            dist.barrier(group=rp.groups.mesh)
        return path

    def _domain_restore(self, directory: str, step: int | None):
        """Same-mesh restore: the manifest's layout must be this engine's;
        each rank loads its shard and re-derives the blocks."""
        step = latest_step(directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        tree, _ = load_checkpoint(directory,
                                  {"layout": self._domain_layout()},
                                  step=step, strict_shapes=False)
        if not np.array_equal(tree["layout"], self._domain_layout()):
            raise ValueError(
                f"checkpoint layout {tree['layout'].tolist()} (ranks, cells, "
                f"K, local cells, replicas) is not this engine's "
                f"{self._domain_layout().tolist()}; restore it onto this "
                "mesh with restore(directory, plan=...) (elastic restore)")
        rp = self._rplan
        shard, gstate, _ = load_md(
            os.path.join(directory, f"rank_{rp.rank:05d}"),
            self._domain_ckpt_tree(self._carry), step=step)
        st = shard["state"]
        with self._halo:
            nbh = self._domain_tables(st.pos, st.spin, shard["idx"],
                                      shard["mask"], shard["tj"], "restore")
        self._carry = DomainCarry(
            st, shard["ff"], nbh, shard["aid"], shard["r0"], shard["trip"],
            shard["n_rebuilds"], shard["n_migrated"],
            np.asarray(shard["n_dropped"]))
        self._sync_domain()
        if gstate is None:
            return None
        if self._batch:
            return [self._generator(g.clone()) for g in gstate]
        return self._generator(gstate)

    def _restore_elastic(self, directory: str, step: int | None, plan):
        """Restore a Sharded checkpoint written on any mesh onto ``plan``
        (a Sharded plan without replicas, on this process's ranks): gather
        every shard into the flat state, re-resolve the plan, re-bin,
        rebuild the tables and re-evaluate (:mod:`repro_torch.ckpt.
        elastic`).  Returns this rank's generator, or None when the
        checkpoint holds none."""
        from repro_torch.ckpt.elastic import gather_md_state, rank_generator
        if not self._sharded or self.replicas:
            raise NotImplementedError(
                "elastic restore re-bins sharded single-trajectory "
                "carries; current plan is "
                f"{type(self.plan).__name__}(replicas={self.replicas})")
        plan = as_plan(plan)
        if not isinstance(plan, Sharded) or plan.replicas:
            raise NotImplementedError(
                "elastic restore targets a Sharded plan without replicas")
        state, seed, _ = gather_md_state(
            directory, self._domain_ckpt_tree(self._carry), step=step,
            device=self.device)
        self.plan = plan
        self.state = state
        self.table = None
        # drop the old mesh's carry BEFORE setup: _step_now falls back to
        # the restored state's step while schedules are re-evaluated
        self.__dict__.pop("_carry", None)
        self._setup_domain()    # re-resolve, re-bin, rebuild, re-evaluate
        if seed is None:
            return None
        return rank_generator(seed, self._rplan.rank, self.device)

    # ------------------------------------------------------------------
    def _health(self, c: FusedCarry, etot0) -> dict:
        """The health signals of :mod:`repro_torch.telemetry.monitor`
        (device tensors)."""
        st, ff = c.state, c.ff
        return {"e_drift": ff.energy + kinetic_energy(st, self.masses) - etot0,
                "spin_dev": spin_norm_dev(st.spin,
                                          self.magnetic[st.types.long()]),
                "nonfinite": nonfinite_count(st.pos, ff.force, st.spin),
                "nbr_occ": occupancy_fraction(c.table.mask)}

    def _chunk(self, carry: FusedCarry, generator, targ, farg, n: int, emit):
        """``n`` steps; returns (carry, {name: (E, ...) observations},
        health vector), all still on the device."""
        etot0 = carry.ff.energy + kinetic_energy(carry.state, self.masses)
        box0 = carry.state.box
        rows = []
        for i in range(n):
            with phase("step"):
                temp, field = _arg_at(targ, i), _arg_at(farg, i)
                # the half-skin test, read back once per step (module
                # docstring)
                with phase("skin_test"):
                    trip = needs_rebuild(carry.table, carry.state.pos, box0,
                                         self.skin)
                    with host_sync():
                        trip = trip.item()
                if trip:
                    st, ff, tab, nbh, perm = self._rebuild(
                        carry.state, carry.perm, field)
                    carry = FusedCarry(st, ff, tab, nbh, perm,
                                       carry.n_rebuilds + 1)
                with phase("integrate"):
                    st, ff, nbh = self._step(carry.state, carry.ff,
                                             carry.nbh, generator, temp,
                                             field)
                carry = carry._replace(state=st, ff=ff, nbh=nbh)
                if emit is not None and i in emit:
                    rows.append(self._observe(st, ff))
        if emit is None:
            rows.append(self._observe(carry.state, carry.ff))
        if rows:
            obs = {k: torch.stack([r[k] for r in rows])
                   for k in self.observables}
        else:   # a tail shorter than obs_every: no row, as the reference
            obs = {k: v[None][:0] for k, v in
                   self._observe(carry.state, carry.ff).items()}
        return carry, obs, self._health(carry, etot0)

    def _readback(self, obs: dict, health: dict):
        """One device -> host transfer of a chunk's observables and health:
        ``({name: (E, ...) array}, {signal: value, or a per-slot list})``."""
        parts, layout = [], []
        for k, v in [(k, obs[k]) for k in self.observables] + list(
                health.items()):
            layout.append((k, tuple(v.shape), v.dtype))
            parts.append(v.reshape(-1).to(torch.float64))
        flat = torch.cat(parts)
        with host_sync():
            flat = flat.cpu().numpy()
        out, at = {}, 0
        for k, shape, dtype in layout:
            size = int(np.prod(shape))
            out[k] = flat[at:at + size].reshape(shape)
            at += size
        obs = {k: out[k].astype(torch.empty((), dtype=dtype).numpy().dtype)
               for k, _, dtype in layout[:len(self.observables)]}
        sig = {}
        for k in health:
            v = out[k].astype(np.int64) if k.endswith("nonfinite") else out[k]
            sig[k] = v.tolist()
        return obs, sig

    # ------------------------------------------------------------------
    def run(self, n_steps: int, generator=None,
            chunk: int = 20, *, temperature=_UNSET, field=_UNSET,
            callback: Callable[["Engine"], None] | None = None,
            checkpoint_dir: str | None = None, checkpoint_every: int = 1,
            checkpoint_keep: int = 3, resume: bool = False,
            telemetry=None) -> SpinLatticeState:
        """Advance ``n_steps`` in chunks of ``chunk``.

        ``temperature`` / ``field`` override the engine-level values for
        this run (None, a constant, or a Schedule); a thermostatted run
        draws its noise from ``generator`` (a ``torch.Generator`` on the
        engine's device; on the replica plan a sequence of R, one per
        replica or slot).  Observables land in ``self.trace``; a ``state``
        assigned between runs (or by ``callback``, which sees the engine
        after every chunk) restarts the carry from it.

        ``checkpoint_dir`` saves the carry and the generator every
        ``checkpoint_every`` chunks and at the end, keeping the newest
        ``checkpoint_keep``; ``resume=True`` first restores the newest
        checkpoint there, carry AND generator, so an interrupted and resumed
        run is bitwise the uninterrupted one.  ``telemetry`` (a
        :class:`repro_torch.telemetry.Telemetry` or a runlog path) writes
        the runlog, checks health at every chunk boundary (raising
        :class:`HealthError` before the failing chunk is checkpointed) and
        optionally dumps a profiler trace.
        """
        with phase("run"):
            tel = as_telemetry(telemetry)
            targ = self._norm_arg(self.temperature if temperature is _UNSET
                                  else temperature, vec=False)
            farg = self._norm_arg(self.field if field is _UNSET else field,
                                  vec=True)
            if self.obs_every is not None and chunk % self.obs_every:
                raise ValueError(f"chunk ({chunk}) must be a multiple of "
                                 f"obs_every ({self.obs_every})")
            if resume:
                if checkpoint_dir is None:
                    raise ValueError("resume=True needs checkpoint_dir")
                if latest_step(checkpoint_dir) is not None:
                    generator = self.restore(checkpoint_dir)
            if ((targ is not None or self.cfg.temperature > 0.0)
                    and generator is None):
                raise ValueError("a thermostatted run needs a torch.Generator"
                                 + (" per replica" if self._batch else ""))
            if self._batch and generator is not None:
                generator = list(generator)
                if len(generator) != self._batch:
                    raise ValueError(
                        f"the replica plan takes one generator per replica "
                        f"of this process: {self._batch}, got "
                        f"{len(generator)}")
            self._restart(farg)
            session = None
            # on the Sharded plan rank 0 alone writes the runlog and the trace
            # (the health signals are global, so every rank gates alike)
            rank0 = not self._sharded or self._rplan.rank == 0
            if tel is not None and rank0:
                session = TelemetrySession(
                    tel, run_info=self._run_info(n_steps, chunk),
                    ledger=self._halo if self._sharded else None)
            try:
                with maybe_trace(tel.profile_dir if tel is not None and rank0
                                 else None):
                    self._run_loop(n_steps, generator, chunk, targ, farg,
                                   callback, checkpoint_dir, checkpoint_every,
                                   checkpoint_keep, tel, session)
            except BaseException as exc:
                if session is not None:
                    session.finish(status="failed", error=str(exc))
                raise
            if session is not None:
                session.finish(status="ok")
            return self.state

    def _restart(self, farg):
        """Honor a caller-swapped ``engine.state`` on the flat and replica
        plans; the Sharded plan refuses one."""
        if self._sharded:
            if self.state is not self._obs_state:
                # repacking the cell-major layout mid-run is not wired up;
                # dropping the swap silently would be worse
                raise NotImplementedError(
                    "state swaps are not supported on the Sharded plan "
                    "(callbacks are observation-only there); build a new "
                    "Engine from the modified state instead")
        elif self._replica:
            self._replica_restart_if_swapped(farg)
        else:
            self._restart_if_swapped(farg)

    def _sync_observation(self):
        if self._sharded:
            self._sync_domain()
        elif self._replica:
            self._sync_replica()
        else:
            self._sync_flat()

    def _run_loop(self, n_steps, generator, chunk, targ, farg, callback,
                  checkpoint_dir, checkpoint_every, checkpoint_keep, tel,
                  session) -> None:
        chunk_fn = (self._domain_chunk if self._sharded else
                    self._replica_chunk if self._replica else self._chunk)
        carry = self._carry
        dt = self.cfg.dt
        t0 = self._step_now() * dt
        rows, times, hrows = [], [], []
        done = chunks_done = 0
        reb_prev = carry.n_rebuilds
        mig_prev = carry.n_migrated if self._sharded else 0
        while done < n_steps:
            with phase("chunk"):
                n = min(chunk, n_steps - done)
                emit = self._emit_for(n)
                if self._fault_injector is not None:
                    # resilience hook (repro_torch.resilience.faults): carry
                    # corruption at the chunk boundary, kept in self._carry
                    carry = self._fault_injector(self, carry, n)
                    self._carry = carry
                targ_c = self._chunk_arg(targ, carry, n, vec=False)
                farg_c = self._chunk_arg(farg, carry, n, vec=True)
                t_chunk = time.perf_counter()
                guard = RangeGuard()
                halo = (self._halo if self._sharded
                        else contextlib.nullcontext())
                with halo, guard:
                    carry, obs, health = chunk_fn(carry, generator, targ_c,
                                                  farg_c, n, emit)
                if guard.bound is not None:
                    health = {**health, _RANGE: guard.bound}
                with phase("readback"):
                    obs, h_host = self._readback(obs, health)
                if guard.bound is not None:
                    guard.check(h_host.pop(_RANGE))
                wall = time.perf_counter() - t_chunk   # the readback synced
                times.extend(t0 + (done + i + 1) * dt for i in (
                    [n - 1] if emit is None else sorted(emit)))
                rows.append(obs)
                hrows.append(h_host)
                done += n
                chunks_done += 1
                self._carry = carry

                # health gate BEFORE checkpointing: a failing chunk must not
                # become the newest checkpoint
                verdict, err = "ok", None
                try:
                    if self._sharded:
                        self._check_dropped(chunk_index=chunks_done - 1)
                    if tel is not None and tel.health is not None:
                        verdict = check_chunk(
                            h_host, tel.health, step=self._step_now(),
                            chunk_index=chunks_done - 1,
                            checkpoint_path=self._last_ckpt)
                except HealthError as e:
                    verdict, err = "fail", e
                if session is not None:
                    counters = {"rebuilds": carry.n_rebuilds - reb_prev}
                    if self._sharded:
                        counters["migrations"] = carry.n_migrated - mig_prev
                        mig_prev = carry.n_migrated
                    session.chunk(
                        steps=n, step=self._step_now(),
                        time_ps=t0 + done * dt, wall_s=wall, health=h_host,
                        verdict=verdict,
                        counters=counters,
                        error=None if err is None else str(err))
                    reb_prev = carry.n_rebuilds
                if err is not None:
                    self._fold_trace(rows, times, hrows)
                    raise err
                if checkpoint_dir is not None and (
                        chunks_done % checkpoint_every == 0
                        or done >= n_steps):
                    self.save(checkpoint_dir, generator, keep=checkpoint_keep)
                if callback is not None:
                    self._sync_observation()
                    callback(self)
                    self._restart(farg)   # the callback may swap the state
                    carry = self._carry
        self._carry = carry
        self._sync_observation()
        self._fold_trace(rows, times, hrows)

    def _fold_trace(self, rows, times, hrows) -> None:
        if not rows:
            return
        self.trace = EngineTrace(
            time=np.asarray(times),
            values={k: np.concatenate([r[k] for r in rows])
                    for k in self.observables},
            health={k: np.asarray([h[k] for h in hrows]) for k in hrows[0]})

    def _run_info(self, n_steps: int, chunk: int) -> dict:
        """Static run descriptor for the runlog header."""
        info = {"plan": type(self.plan).__name__, "n_steps": n_steps,
                "chunk": chunk, "n_atoms": int(self.state.pos.shape[-2]),
                "dt_ps": float(self.cfg.dt), "replicas": self.replicas,
                "observables": list(self.observables),
                "obs_every": self.obs_every,
                "potential": type(self.potential).__name__,
                "device": str(self.device)}
        if self.per_slot:
            info["per_slot"] = True
        if self._sharded:
            info.update(self._rplan.describe())
        info.update(self.run_tags or {})
        return info

    def rebind(self, *, cfg: IntegratorConfig | None = None,
               skin: float | None = None, plan=None) -> None:
        """Rebuild the loop around a new config / skin / plan at a chunk
        boundary: the supervisor's degradation lever.

        The carry is synced to ``self.state`` (input atom order), the knobs
        are swapped and the plan's setup re-runs from that state, as at
        construction.  Positions, velocities, spins and the step carry over
        bitwise (and the run's generators, which the caller holds); the
        neighbor table and the forces are rebuilt (on the Sharded plan the
        cells are re-resolved and the atoms re-binned).  A new ``plan``
        swaps the plan: on the Sharded plan a new cell grid, capacity or
        mesh (the supervisor's capacity rung), or another plan kind; a flat
        state is tiled for a Replicated plan.  The replicas x domain plan
        is rejected, as by the reference: its batch cannot be re-packed
        through one flat state.
        """
        if self._sharded and self.replicas:
            raise NotImplementedError(
                "rebind on the replicated-sharded plan is not supported "
                "(the flat re-pack path is single-trajectory)")
        self._sync_observation()
        if cfg is not None:
            self.cfg = cfg
        if skin is not None:
            self.skin = skin
        count = self._carry.n_rebuilds      # cumulative across rebinds
        if plan is not None:
            self._swap_plan(as_plan(plan, replicas=self.replicas))
        self.table = None
        if self._sharded:
            self._setup_domain()
            self._carry = self._carry._replace(n_rebuilds=count)
            return
        if self._replica:
            if self.state.pos.dim() == 2:
                st = replicate(self.state, self.plan.replicas)
                self.state = st._replace(step=np.full(
                    self.plan.replicas, int(self.state.step), np.int64))
            self._setup_replica()
            self._carry = self._carry._replace(n_rebuilds=count)
            if self.plan.devices is not None:
                self.shard_replicas(self.plan.devices)
            return
        self._setup_flat()
        self._init_carry(field_now=self._value_now(
            self._norm_arg(self.field, vec=True), vec=True))
        self._carry = self._carry._replace(n_rebuilds=count)

    def _swap_plan(self, plan) -> None:
        """Take ``plan`` for the next setup.  The state's form follows: one
        flat state for the flat and Sharded plans (a replica batch only
        when it holds one replica)."""
        if self._replica and not isinstance(plan, Replicated):
            if self.state.pos.shape[0] != 1:
                raise ValueError("a replica batch cannot be re-packed into "
                                 "one flat state; keep the Replicated plan")
            self.state = unstack_state(self.state, 0)
        if (self._replica and isinstance(plan, Replicated)
                and plan.replicas != self.plan.replicas):
            raise ValueError("rebind keeps the replica count")
        if self.per_slot and not isinstance(plan, Replicated):
            raise ValueError("per_slot=True requires the Replicated plan")
        self.plan = plan
        self._replica = isinstance(plan, Replicated)
        self._sharded = isinstance(plan, Sharded)
        self._batch = plan.replicas if self._replica else 0
        self._rep0 = 0
        self._rep_ranks = self._rep_group = None
        if self._sharded and not hasattr(self, "_halo"):
            self._halo = HaloTrace()
        self.__dict__.pop("_carry", None)   # _step_now -> state.step

    # ------------------------------------------------------------------
    def _ckpt_tree(self, c) -> dict:
        """What a checkpoint holds: the carry without its neighbor blocks,
        which :meth:`restore` re-derives from ``table`` and ``state`` (on
        a replica plan split over ranks, every replica's rows)."""
        if self._replica:
            states, ffs = self._full_batch(c)
            return {"states": states, "ffs": ffs, "table": c.table,
                    "n_rebuilds": c.n_rebuilds}
        return {"state": c.state, "ff": c.ff, "table": c.table,
                "perm": c.perm, "n_rebuilds": c.n_rebuilds}

    def save(self, directory: str, generator, keep: int = 3) -> str:
        """Checkpoint the carry and ``generator`` (the run's generator in
        its current state - on the replica plan the list of one per
        replica, saved as a stack; None for a run that draws no noise) at a
        chunk boundary.  Returns the checkpoint's path.

        On the Sharded plan every rank calls it with its own generator:
        each writes its shard, rank 0 the manifest."""
        step = self.ckpt_step()
        if self._sharded:
            path = self._domain_save(directory, generator, keep)
            self._last_ckpt, self._last_ckpt_step = path, step
            return path
        tree = self._ckpt_tree(self._carry)
        if self._rep_ranks is not None:
            # one checkpoint of every replica and generator, as one
            # process writes it: the first replica rank writes it
            import torch.distributed as dist
            mine = [] if generator is None else [g.get_state()
                                                 for g in generator]
            got = [None] * len(self._rep_ranks)
            dist.all_gather_object(got, mine, group=self._rep_group)
            order = sorted(self._rep_ranks)
            states = [st for r in self._rep_ranks
                      for st in got[order.index(r)]]
            if dist.get_rank() == self._rep_ranks[0]:
                save_md(directory, step, tree, states or None, keep=keep,
                        pin=self.ckpt_pin)
            dist.barrier(group=self._rep_group)
            path = os.path.join(directory, f"step_{step:09d}")
            self._last_ckpt, self._last_ckpt_step = path, step
            return path
        path = save_md(directory, step, tree, generator, keep=keep,
                       pin=self.ckpt_pin)
        self._last_ckpt, self._last_ckpt_step = path, step
        return path

    def restore(self, directory: str, step: int | None = None, *,
                plan=None):
        """Restore the carry from a checkpoint (the newest by default);
        returns the saved generator state as a ``torch.Generator`` on the
        engine's device - on a replica plan a list of them, one per
        replica of this process - or None if none was saved.
        ``run(remaining, g)`` then continues the trajectory bitwise.  On
        the Sharded plan each rank restores its own shard and generator(s),
        onto the same mesh.

        ``plan`` (a Sharded plan) switches on **elastic restore**: the
        checkpoint of a Sharded run on any mesh - any number of ranks - is
        gathered into the flat state in input atom order, the plan is
        re-resolved on this engine's ranks, the atoms re-binned, the tables
        rebuilt and the forces re-evaluated (a chunk boundary's rebuild).
        The generator handed back is this rank's of a fresh Sharded run
        whose seed is derived from the checkpoint's generator states
        (:func:`repro_torch.ckpt.elastic.rank_generator`): a thermostatted
        run is not bitwise across an elastic restore (nor is the
        reference's)."""
        if plan is not None:
            return self._restore_elastic(directory, step, plan)
        if self._sharded:
            return self._domain_restore(directory, step)
        tree, gstate, _ = load_md(directory, self._ckpt_tree(self._carry),
                                  step=step)
        if self._replica:
            tab = tree["table"]
            st = self._own_rows(tree["states"])
            if not torch.equal(st.box[0], self._box0):
                raise ValueError("the checkpoint holds another box; restore "
                                 "it into an Engine built for that geometry")
            own = slice(self._rep0, self._rep0 + self._batch)
            ffs = tree["ffs"]
            if self._rep_ranks is not None:
                ffs = ForceField(*(x[own] for x in ffs))
            self._carry = ReplicaCarry(st, ffs, tab,
                                       self._shared(tab, st.pos),
                                       tree["n_rebuilds"])
            self._sync_replica()
            if gstate is None:
                return None
            return [self._generator(g.clone()) for g in gstate[own]]
        st, tab = tree["state"], tree["table"]
        if not torch.equal(st.box, self._carry.state.box):
            self.state = st      # a new geometry: re-derive the statics
            self._setup_flat()
        self._carry = FusedCarry(st, tree["ff"], tab, self._gather(st, tab),
                                 tree["perm"], tree["n_rebuilds"])
        self._sync_flat()
        return None if gstate is None else self._generator(gstate)

    def _generator(self, gstate) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.set_state(gstate)
        return gen
