"""The spin-lattice simulation engine, flat single-device plan (port of
``repro.md.engine``).

A chunked loop over :func:`repro_torch.md.integrator.make_fused_step`:
before every step it runs the half-skin test and, when it trips, rebuilds
the neighbor table (re-sorting the rows into linked-cell order first when
the plan asks for it), gathers the blocks and re-evaluates the potential;
then it steps, and it records the observables of
:mod:`repro_torch.md.analysis` and the health signals at chunk boundaries.

Host syncs: the reference runs the rebuild test inside its compiled scan
behind a ``lax.cond``.  Here the test runs on the device every step and is
read back with one ``.item()`` - one host sync per step.  Capturing a chunk
as a CUDA graph with a device-side rebuild flag would remove it; that is
later work.  Observables and health signals are read once per chunk.

Not ported yet (they raise ``NotImplementedError``): the ``Replicated`` and
``Sharded`` plans, schedules for ``temperature`` / ``field`` (constants
only), checkpoints, telemetry, and the ``pitch`` observable.  Nor are the
reference's in-chunk observable streaming (``obs_every``), per-chunk
callbacks, or a caller-supplied initial table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.md.analysis import (magnetization, skyrmion_count,
                                     topological_charge)
from repro_torch.md.integrator import (ForceField, IntegratorConfig,
                                       make_fused_step)
from repro_torch.md.neighbor import (NeighborTable, Neighborhood, cell_order,
                                     gather_blocks, make_table_builder,
                                     needs_rebuild, refresh_dr)
from repro_torch.md.state import SpinLatticeState, kinetic_energy
from repro_torch.parallel.plan import as_plan
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
    """Observables and health signals, one row per chunk."""

    time: np.ndarray
    values: dict[str, np.ndarray]
    health: dict[str, np.ndarray] | None = None


OBSERVABLES = ("energy", "kinetic", "magnetization", "charge",
               "skyrmion_count")


def _check_names(names) -> tuple:
    names = tuple(names)
    for n in names:
        if n == "pitch":
            raise NotImplementedError("the pitch observable is not ported")
        if n not in OBSERVABLES:
            raise ValueError(f"unknown observable {n!r}; "
                             f"available: {OBSERVABLES}")
    return names


def make_flat_observe(names, masses, magnetic, diag_grid) -> Callable:
    """Observable pipeline over flat (N, ...) tensors."""
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
        return {k: vals[k] for k in names}

    return observe


def _permute_atoms(state: SpinLatticeState, order) -> SpinLatticeState:
    return state._replace(pos=state.pos[order], vel=state.vel[order],
                          spin=state.spin[order], types=state.types[order])


def _is_schedule(x) -> bool:
    return hasattr(x, "at") and hasattr(x, "times")


_UNSET = object()


@dataclasses.dataclass
class Engine:
    """Flat single-device MD engine (see the module docstring).

    ``state``, ``masses``, ``magnetic`` and the potential's parameters must
    already live on ``device`` (default ``"cuda"``; an engine asked for the
    card on a host without one raises).
    """

    potential: Any
    cfg: IntegratorConfig
    state: SpinLatticeState
    masses: torch.Tensor               # (n_types,)
    magnetic: torch.Tensor             # (n_types,) bool
    cutoff: float
    plan: Any = None                   # None | "single" | SingleDevice
    temperature: float | None = None   # K; constants only
    field: Any = None                  # (3,) Tesla; constants only
    observables: tuple = ("energy", "kinetic", "magnetization", "charge")
    capacity: int = 64                 # per-atom neighbor capacity M
    skin: float = 0.5
    use_cell_list: bool = False
    cell_capacity: int = 24
    diag_grid: tuple = (32, 32)
    device: Any = "cuda"
    # observation state: the table in input row order, the last run's trace
    table: NeighborTable | None = dataclasses.field(default=None, init=False)
    trace: EngineTrace | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.plan = as_plan(self.plan)
        self.observables = _check_names(self.observables)
        for name, t in (("state.pos", self.state.pos),
                        ("masses", self.masses),
                        ("magnetic", self.magnetic)):
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}; the engine runs "
                                 f"on {self.device}")
        self._setup_flat()
        self._init_carry(self._const(self.field, vec=True))

    # ------------------------------------------------------------------
    @property
    def n_rebuilds(self) -> int:
        return self._carry.n_rebuilds

    @property
    def energy(self) -> float:
        return float(self._carry.ff.energy)

    def _const(self, x, vec: bool):
        if x is None:
            return None
        if _is_schedule(x):
            raise NotImplementedError("schedules are not ported; pass a "
                                      "constant temperature / field")
        if vec:
            return torch.as_tensor(x, dtype=self.state.pos.dtype,
                                   device=self.device)
        return float(x)

    # ------------------------------------------------------------------
    def _setup_flat(self):
        """Geometry-static setup: table builder, ordering, step closure."""
        build, n_cells, use_cell = make_table_builder(
            self.state.box, self.cutoff, self.capacity, self.cell_capacity,
            self.skin, self.use_cell_list)
        self._reorder = (self.plan.cell_order
                         if self.plan.cell_order is not None else use_cell)
        self._build, self._n_cells = build, n_cells
        box0 = self.state.box
        self._step = make_fused_step(
            gather=lambda pos, nbh: refresh_dr(nbh, pos, box0),
            compute=self._compute_ff, cfg=self.cfg, masses=self.masses,
            magnetic=self.magnetic)
        self._observe = make_flat_observe(self.observables, self.masses,
                                          self.magnetic, self.diag_grid)

    def _compute_ff(self, nbh, spin, types, field) -> ForceField:
        return ForceField(*self.potential.compute(nbh, spin, types, field))

    def _rebuild(self, state, perm, field):
        """(Re)order atoms, rebuild the table, gather, evaluate."""
        if self._reorder:
            order = cell_order(state.pos, state.box, self._n_cells)
            state = _permute_atoms(state, order)
            perm = perm[order]
        table = self._build(state.pos, state.box)
        nbh = gather_blocks(state.pos, state.types, table, state.box)
        ff = self._compute_ff(nbh, state.spin, state.types, field)
        return state, ff, table, nbh, perm

    def _init_carry(self, field_now=None):
        """(Re)build the hot carry from ``self.state`` at the given field;
        the rebuild count is cumulative across restarts."""
        perm0 = torch.arange(self.state.pos.shape[0], device=self.device)
        count0 = (self._carry.n_rebuilds
                  if getattr(self, "_carry", None) is not None else 0)
        st, ff, tab, nbh, perm = self._rebuild(self.state, perm0, field_now)
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

    def _restart_if_swapped(self, field):
        """Honor a caller-swapped ``engine.state``: same box restarts the
        carry, a new box re-derives the geometry."""
        if self.state is self._obs_state:
            return
        if not torch.equal(self.state.box, self._carry.state.box):
            self._setup_flat()
        self._init_carry(field)

    # ------------------------------------------------------------------
    def _health(self, c: FusedCarry, etot0) -> dict:
        st, ff = c.state, c.ff
        mag = self.magnetic[st.types.long()]
        dev = torch.abs(torch.linalg.norm(st.spin, dim=-1) - 1.0)
        nonfinite = sum(int(torch.sum(~torch.isfinite(a)))
                        for a in (st.pos, ff.force, st.spin))
        return {
            "e_drift": float(ff.energy + kinetic_energy(st, self.masses)
                             - etot0),
            "spin_dev": float(torch.max(torch.where(mag, dev,
                                                    torch.zeros_like(dev)))),
            "nonfinite": nonfinite,
            "nbr_occ": float(c.table.mask.sum(dim=1).max()) / c.table.capacity,
        }

    def _chunk(self, carry: FusedCarry, generator, temp, field, n: int):
        etot0 = carry.ff.energy + kinetic_energy(carry.state, self.masses)
        box0 = self.state.box
        for _ in range(n):
            # the half-skin test, read back once per step (module docstring)
            if needs_rebuild(carry.table, carry.state.pos, box0,
                             self.skin).item():
                st, ff, tab, nbh, perm = self._rebuild(carry.state,
                                                       carry.perm, field)
                carry = FusedCarry(st, ff, tab, nbh, perm,
                                   carry.n_rebuilds + 1)
            st, ff, nbh = self._step(carry.state, carry.ff, carry.nbh,
                                     generator, temp, field)
            carry = carry._replace(state=st, ff=ff, nbh=nbh)
        return (carry, self._observe(carry.state, carry.ff),
                self._health(carry, etot0))

    def run(self, n_steps: int, generator: torch.Generator | None = None,
            chunk: int = 20, *, temperature=_UNSET, field=_UNSET,
            checkpoint_dir: str | None = None,
            telemetry=None) -> SpinLatticeState:
        """Advance ``n_steps`` in chunks of ``chunk``.

        ``temperature`` / ``field`` override the engine-level constants for
        this run; a thermostatted run draws its noise from ``generator``
        (a ``torch.Generator`` on the engine's device).  Observables land in
        ``self.trace``.  A ``state`` assigned between runs restarts the
        carry from it.
        """
        if checkpoint_dir is not None or telemetry is not None:
            raise NotImplementedError("checkpoints and telemetry are not "
                                      "ported yet")
        temp = self._const(self.temperature if temperature is _UNSET
                           else temperature, vec=False)
        fld = self._const(self.field if field is _UNSET else field, vec=True)
        if ((temp is not None or self.cfg.temperature > 0.0)
                and generator is None):
            raise ValueError("a thermostatted run needs a torch.Generator")
        self._restart_if_swapped(fld)
        carry = self._carry
        t0 = carry.state.step * self.cfg.dt
        rows, times, hrows = [], [], []
        done = 0
        while done < n_steps:
            n = min(chunk, n_steps - done)
            carry, obs, health = self._chunk(carry, generator, temp, fld, n)
            done += n
            times.append(t0 + done * self.cfg.dt)
            rows.append({k: v.detach().cpu().numpy() for k, v in obs.items()})
            hrows.append(health)
        self._carry = carry
        self._sync_flat()
        if rows:
            self.trace = EngineTrace(
                time=np.asarray(times),
                values={k: np.stack([r[k] for r in rows])
                        for k in self.observables},
                health={k: np.asarray([h[k] for h in hrows])
                        for k in hrows[0]})
        return self.state
