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
  transfer;
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
rebuild adds one more (the cell-overflow check, and the table's transpose
for potentials that sum pair reactions), and a chunk end one readback.

Not ported yet (they raise ``NotImplementedError``): the ``Replicated``
plan with its per-slot mode (ROADMAP queue 1 item 9), ``Engine.rebind``
(item 11), and the ``Sharded`` plan with elastic restore (item 13).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import latest_step, load_md, save_md
from repro_torch.ensemble.protocol import host_rows
from repro_torch.md.analysis import (helix_pitch, magnetization,
                                     skyrmion_count, topological_charge)
from repro_torch.md.integrator import (ForceField, IntegratorConfig,
                                       make_fused_step)
from repro_torch.md.neighbor import (NeighborTable, Neighborhood, cell_order,
                                     gather_blocks, make_table_builder,
                                     needs_rebuild, refresh_dr)
from repro_torch.md.state import SpinLatticeState, kinetic_energy
from repro_torch.parallel.plan import as_plan
from repro_torch.telemetry import (HealthError, TelemetrySession,
                                   as_telemetry, check_chunk, maybe_trace,
                                   phase)
from repro_torch.telemetry.monitor import (nonfinite_count,
                                           occupancy_fraction, spin_norm_dev)
from repro_torch.utils.device import resolve_device


class FusedCarry(NamedTuple):
    """Loop state of the flat plan."""

    state: SpinLatticeState   # hot (possibly cell-ordered) row order
    ff: ForceField
    table: NeighborTable
    nbh: Neighborhood
    perm: torch.Tensor        # (N,) hot row -> original atom id
    n_rebuilds: int


class EngineTrace(NamedTuple):
    """Observables, one row per emission (chunk end, or every
    ``obs_every`` steps), and the health signals, one row per chunk."""

    time: np.ndarray
    values: dict[str, np.ndarray]
    health: dict[str, np.ndarray] | None = None


OBSERVABLES = ("energy", "kinetic", "magnetization", "charge",
               "skyrmion_count", "pitch")
HEALTH = ("e_drift", "spin_dev", "nonfinite", "nbr_occ")


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


def _permute_atoms(state: SpinLatticeState, order) -> SpinLatticeState:
    return state._replace(pos=state.pos[order], vel=state.vel[order],
                          spin=state.spin[order], types=state.types[order])


def _is_schedule(x) -> bool:
    return hasattr(x, "at") and hasattr(x, "times") and hasattr(x, "values")


class _StepValues(NamedTuple):
    """A schedule lowered to one chunk's per-step values: a list of Python
    floats (temperature) or an (n, 3) device tensor (field)."""

    rows: Any


def _arg_at(arg, i: int):
    return arg.rows[i] if isinstance(arg, _StepValues) else arg


_UNSET = object()


@dataclasses.dataclass
class Engine:
    """Flat single-device MD engine (see the module docstring).

    ``state``, ``masses``, ``magnetic`` and the potential's parameters must
    already live on ``device`` (default ``"cuda"``; an engine asked for the
    card on a host without one raises).  ``table``, if given, is the
    initial neighbor table in ``state``'s row order.
    """

    potential: Any
    cfg: IntegratorConfig
    state: SpinLatticeState
    masses: torch.Tensor               # (n_types,)
    magnetic: torch.Tensor             # (n_types,) bool
    cutoff: float
    plan: Any = None                   # None | "single" | SingleDevice
    temperature: Any = None            # None | K | Schedule
    field: Any = None                  # None | (3,) Tesla | Schedule
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
    trace: EngineTrace | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.plan = as_plan(self.plan)
        self.observables = _check_names(self.observables)
        if self.obs_every is not None and self.obs_every < 1:
            raise ValueError("obs_every must be >= 1")
        if not hasattr(self.potential, "compute"):
            raise ValueError("the flat engine plan requires a potential "
                             "with the gather-once .compute() surface")
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
        self.ckpt_pin = None        # a step save() must never collect
        self._setup_flat()
        self._init_carry(table=self.table, field_now=self._value_now(
            self._norm_arg(self.field, vec=True), vec=True))

    # ------------------------------------------------------------------
    @property
    def dt(self) -> float:
        return self.cfg.dt

    @property
    def n_rebuilds(self) -> int:
        return self._carry.n_rebuilds

    @property
    def energy(self) -> float:
        return float(self._carry.ff.energy)

    def _step_now(self) -> int:
        c = getattr(self, "_carry", None)
        return self.state.step if c is None else c.state.step

    def ckpt_step(self) -> int:
        """The step tag :meth:`save` would use now (the carry's clock)."""
        return self._step_now()

    # ------------------------------------------------------------------
    # schedule arguments
    # ------------------------------------------------------------------
    def _norm_arg(self, x, vec: bool):
        """None and Schedules pass through; a constant becomes a Python
        float (temperature) or a (3,) tensor on the device (field)."""
        if x is None:
            return None
        if _is_schedule(x):
            if np.ndim(x.times) != 1:
                raise ValueError("per-slot SlotSchedules need the Replicated "
                                 "plan (ROADMAP queue 1 item 9)")
            return x
        if vec:
            return torch.as_tensor(x, dtype=self.state.pos.dtype,
                                   device=self.device)
        return float(x)

    def _value_now(self, arg, vec: bool):
        """A schedule's value at the current step (host float32)."""
        if not _is_schedule(arg):
            return arg
        v = host_rows(arg, np.float32(self._step_now())
                      * np.float32(self.cfg.dt))
        if vec:
            return torch.as_tensor(v, dtype=self.state.pos.dtype,
                                   device=self.device)
        return float(v)

    def _chunk_arg(self, arg, carry: FusedCarry, n: int):
        """Lower a schedule to this chunk's per-step values: times
        ``t0 + i * dt`` and the rows in numpy float32, exactly as the
        reference; constants pass through."""
        if not _is_schedule(arg):
            return arg
        dt = np.float32(self.cfg.dt)
        t = (np.float32(carry.state.step) * dt
             + np.arange(n, dtype=np.float32) * dt)
        rows = host_rows(arg, t)
        if rows.ndim == 2:
            return _StepValues(torch.as_tensor(
                rows, dtype=self.state.pos.dtype, device=self.device))
        return _StepValues([float(v) for v in rows])

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
            gather=lambda pos, nbh: refresh_dr(nbh, pos, box0),
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

    # ------------------------------------------------------------------
    def _health(self, c: FusedCarry, etot0) -> torch.Tensor:
        """The :data:`HEALTH` signals as one device vector."""
        st, ff = c.state, c.ff
        dt = ff.energy.dtype
        return torch.stack([
            ff.energy + kinetic_energy(st, self.masses) - etot0,
            spin_norm_dev(st.spin, self.magnetic[st.types.long()]).to(dt),
            nonfinite_count(st.pos, ff.force, st.spin).to(dt),
            occupancy_fraction(c.table.mask).to(dt)])

    def _chunk(self, carry: FusedCarry, generator, targ, farg, n: int, emit):
        """``n`` steps; returns (carry, {name: (E, ...) observations},
        health vector), all still on the device."""
        etot0 = carry.ff.energy + kinetic_energy(carry.state, self.masses)
        box0 = carry.state.box
        rows = []
        for i in range(n):
            temp, field = _arg_at(targ, i), _arg_at(farg, i)
            # the half-skin test, read back once per step (module docstring)
            if needs_rebuild(carry.table, carry.state.pos, box0,
                             self.skin).item():
                st, ff, tab, nbh, perm = self._rebuild(carry.state,
                                                       carry.perm, field)
                carry = FusedCarry(st, ff, tab, nbh, perm,
                                   carry.n_rebuilds + 1)
            with phase("integrate"):
                st, ff, nbh = self._step(carry.state, carry.ff, carry.nbh,
                                         generator, temp, field)
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

    def _readback(self, obs: dict, health: torch.Tensor):
        """One device -> host transfer of a chunk's observables and health:
        ``({name: (E, ...) array}, {signal: value})``."""
        parts, layout = [], []
        for k in self.observables:
            v = obs[k]
            layout.append((k, tuple(v.shape), v.dtype))
            parts.append(v.reshape(-1).to(torch.float64))
        flat = torch.cat(parts + [health.to(torch.float64)]).cpu().numpy()
        obs, at = {}, 0
        for k, shape, dtype in layout:
            size = int(np.prod(shape))
            obs[k] = flat[at:at + size].reshape(shape).astype(
                torch.empty((), dtype=dtype).numpy().dtype)
            at += size
        sig = dict(zip(HEALTH, flat[at:].tolist()))
        sig["nonfinite"] = int(sig["nonfinite"])
        return obs, sig

    # ------------------------------------------------------------------
    def run(self, n_steps: int, generator: torch.Generator | None = None,
            chunk: int = 20, *, temperature=_UNSET, field=_UNSET,
            callback: Callable[["Engine"], None] | None = None,
            checkpoint_dir: str | None = None, checkpoint_every: int = 1,
            checkpoint_keep: int = 3, resume: bool = False,
            telemetry=None) -> SpinLatticeState:
        """Advance ``n_steps`` in chunks of ``chunk``.

        ``temperature`` / ``field`` override the engine-level values for
        this run (None, a constant, or a Schedule); a thermostatted run
        draws its noise from ``generator`` (a ``torch.Generator`` on the
        engine's device).  Observables land in ``self.trace``; a ``state``
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
            raise ValueError("a thermostatted run needs a torch.Generator")
        self._restart_if_swapped(farg)
        session = None
        if tel is not None:
            session = TelemetrySession(tel,
                                       run_info=self._run_info(n_steps, chunk))
        try:
            with maybe_trace(tel.profile_dir if tel is not None else None):
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

    def _run_loop(self, n_steps, generator, chunk, targ, farg, callback,
                  checkpoint_dir, checkpoint_every, checkpoint_keep, tel,
                  session) -> None:
        carry = self._carry
        dt = self.cfg.dt
        t0 = self._step_now() * dt
        rows, times, hrows = [], [], []
        done = chunks_done = 0
        reb_prev = carry.n_rebuilds
        while done < n_steps:
            n = min(chunk, n_steps - done)
            emit = self._emit_for(n)
            targ_c = self._chunk_arg(targ, carry, n)
            farg_c = self._chunk_arg(farg, carry, n)
            t_chunk = time.perf_counter()
            carry, obs, health = self._chunk(carry, generator, targ_c,
                                             farg_c, n, emit)
            obs, h_host = self._readback(obs, health)
            wall = time.perf_counter() - t_chunk   # the readback synced
            times.extend(t0 + (done + i + 1) * dt
                         for i in ([n - 1] if emit is None else sorted(emit)))
            rows.append(obs)
            hrows.append(h_host)
            done += n
            chunks_done += 1
            self._carry = carry

            # health gate BEFORE checkpointing: a failing chunk must not
            # become the newest checkpoint
            verdict, err = "ok", None
            if tel is not None and tel.health is not None:
                try:
                    verdict = check_chunk(
                        h_host, tel.health, step=self._step_now(),
                        chunk_index=chunks_done - 1,
                        checkpoint_path=self._last_ckpt)
                except HealthError as e:
                    verdict, err = "fail", e
            if session is not None:
                session.chunk(
                    steps=n, step=self._step_now(), time_ps=t0 + done * dt,
                    wall_s=wall, health=h_host, verdict=verdict,
                    counters={"rebuilds": carry.n_rebuilds - reb_prev},
                    error=None if err is None else str(err))
                reb_prev = carry.n_rebuilds
            if err is not None:
                self._fold_trace(rows, times, hrows)
                raise err
            if checkpoint_dir is not None and (
                    chunks_done % checkpoint_every == 0 or done >= n_steps):
                self.save(checkpoint_dir, generator, keep=checkpoint_keep)
            if callback is not None:
                self._sync_flat()
                callback(self)
                self._restart_if_swapped(farg)   # the callback may swap it
                carry = self._carry
        self._carry = carry
        self._sync_flat()
        self._fold_trace(rows, times, hrows)

    def _fold_trace(self, rows, times, hrows) -> None:
        if not rows:
            return
        self.trace = EngineTrace(
            time=np.asarray(times),
            values={k: np.concatenate([r[k] for r in rows])
                    for k in self.observables},
            health={k: np.asarray([h[k] for h in hrows]) for k in HEALTH})

    def _run_info(self, n_steps: int, chunk: int) -> dict:
        """Static run descriptor for the runlog header."""
        return {"plan": type(self.plan).__name__, "n_steps": n_steps,
                "chunk": chunk, "n_atoms": int(self.state.pos.shape[0]),
                "dt_ps": float(self.cfg.dt), "replicas": 0,
                "observables": list(self.observables),
                "obs_every": self.obs_every,
                "potential": type(self.potential).__name__,
                "device": str(self.device)}

    def rebind(self, **kwargs):
        """Rebuild the loop around a new config / skin / plan (the
        supervisor's degradation lever): not ported yet."""
        raise NotImplementedError("Engine.rebind is ROADMAP queue 1 item 11 "
                                  "(the resilience supervisor)")

    # ------------------------------------------------------------------
    def _ckpt_tree(self, c: FusedCarry) -> dict:
        """What a checkpoint holds: the carry without its neighbor blocks,
        which :meth:`restore` re-derives from ``table`` and ``state``."""
        return {"state": c.state, "ff": c.ff, "table": c.table,
                "perm": c.perm, "n_rebuilds": c.n_rebuilds}

    def save(self, directory: str, generator: torch.Generator | None,
             keep: int = 3) -> str:
        """Checkpoint the carry and ``generator`` (the run's generator in
        its current state; None for a run that draws no noise) at a chunk
        boundary.  Returns the checkpoint's path."""
        path = save_md(directory, self.ckpt_step(),
                       self._ckpt_tree(self._carry), generator, keep=keep,
                       pin=self.ckpt_pin)
        self._last_ckpt = path
        return path

    def restore(self, directory: str,
                step: int | None = None) -> torch.Generator | None:
        """Restore the carry from a checkpoint (the newest by default);
        returns the saved generator state as a ``torch.Generator`` on the
        engine's device (None if none was saved).  ``run(remaining, g)``
        then continues the trajectory bitwise."""
        tree, gstate, _ = load_md(directory, self._ckpt_tree(self._carry),
                                  step=step)
        st, tab = tree["state"], tree["table"]
        if not torch.equal(st.box, self._carry.state.box):
            self.state = st      # a new geometry: re-derive the statics
            self._setup_flat()
        self._carry = FusedCarry(st, tree["ff"], tab, self._gather(st, tab),
                                 tree["perm"], tree["n_rebuilds"])
        self._sync_flat()
        if gstate is None:
            return None
        gen = torch.Generator(device=self.device)
        gen.set_state(gstate)
        return gen
