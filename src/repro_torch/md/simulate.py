"""Simulation drivers: facades over the engine (port of
``repro.md.simulate``).

:class:`Simulation` is the single-trajectory driver.  ``fused=True`` (the
default whenever the potential has the gather-once ``compute`` surface)
delegates to the flat :class:`~repro_torch.md.engine.Engine`: the in-chunk
half-skin rebuild, gather-once evaluations and per-chunk diagnostics.
``fused=False`` is the legacy path kept as the parity baseline: the skin
test runs on the host between chunks, a rebuild rebuilds the table and the
step closure, and every force call is a whole evaluation
(``potential.energy_forces_field``) through :func:`make_step`.

:class:`SimulationSharded` is the domain-decomposed driver, a facade over
the engine's ``Sharded`` plan (:mod:`repro_torch.parallel.domain`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.md.engine import Engine
from repro_torch.md.integrator import ForceField, IntegratorConfig, make_step
from repro_torch.md.neighbor import (NeighborTable, cell_neighbor_table,
                                     dense_neighbor_table, needs_rebuild)
from repro_torch.md.state import SpinLatticeState
from repro_torch.parallel.plan import SingleDevice
from repro_torch.utils.device import resolve_device


class ChunkTrace(NamedTuple):
    """Per-chunk diagnostics of the fused path (C chunks)."""

    time: np.ndarray           # (C,) ps at chunk ends
    energy: np.ndarray         # (C,) potential energy [eV]
    kinetic: np.ndarray        # (C,) lattice kinetic energy [eV]
    magnetization: np.ndarray  # (C, 3) mean spin over magnetic sites
    charge: np.ndarray         # (C,) Berg-Luscher topological charge


@dataclasses.dataclass
class Simulation:
    potential: Any                     # .compute and/or .energy_forces_field
    cfg: IntegratorConfig
    state: SpinLatticeState
    masses: torch.Tensor               # (n_types,)
    magnetic: torch.Tensor             # (n_types,) bool
    cutoff: float
    capacity: int = 64
    skin: float = 0.5
    field: Any = None                  # (3,) Tesla
    use_cell_list: bool = False
    cell_capacity: int = 24
    fused: bool | None = None          # None -> fused iff potential.compute
    cell_order: bool | None = None     # cell-ordered rows; None -> cell list
    diag_grid: tuple[int, int] = (32, 32)
    device: Any = "cuda"
    table: NeighborTable | None = None
    trace: ChunkTrace | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.state.pos.device != self.device:
            raise ValueError(f"state.pos is on {self.state.pos.device}; the "
                             f"simulation runs on {self.device}")
        self._fused = (hasattr(self.potential, "compute")
                       if self.fused is None else self.fused)
        self._legacy_rebuilds = 0
        if self._fused:
            if not hasattr(self.potential, "compute"):
                raise ValueError("fused=True requires a potential with the "
                                 "gather-once .compute() surface")
            self._engine = Engine(
                potential=self.potential, cfg=self.cfg, state=self.state,
                masses=self.masses, magnetic=self.magnetic,
                cutoff=self.cutoff,
                plan=SingleDevice(cell_order=self.cell_order),
                field=self.field,
                observables=("energy", "kinetic", "magnetization", "charge"),
                capacity=self.capacity, skin=self.skin,
                use_cell_list=self.use_cell_list,
                cell_capacity=self.cell_capacity, diag_grid=self.diag_grid,
                device=self.device, table=self.table)
            self._pull()
        else:
            self._refresh(build_table=self.table is None)

    # ------------------------------------------------------------------
    # fused path: delegation to the engine's flat plan
    # ------------------------------------------------------------------
    def _pull(self):
        """Mirror the engine's observation state onto the facade."""
        self.state = self._engine.state
        self.table = self._engine.table
        self._ff = self._engine._ff

    @property
    def n_rebuilds(self) -> int:
        """Neighbor-table rebuilds so far."""
        if self._fused:
            return self._engine.n_rebuilds
        return self._legacy_rebuilds

    # ------------------------------------------------------------------
    # legacy path: host-side skin test, whole evaluations
    # ------------------------------------------------------------------
    def _build_table(self, pos) -> NeighborTable:
        if self.use_cell_list:
            return cell_neighbor_table(pos, self.state.box, self.cutoff,
                                       self.capacity,
                                       cell_capacity=self.cell_capacity,
                                       skin=self.skin)
        return dense_neighbor_table(pos, self.state.box, self.cutoff,
                                    self.capacity, skin=self.skin)

    def _refresh(self, build_table: bool = True):
        """(Re)build the table and the step closure after atoms drift."""
        if build_table:
            self.table = self._build_table(self.state.pos)
        table, st = self.table, self.state

        def evaluate(pos, spin, field=None):
            f = self.field if field is None else field
            return self.potential.energy_forces_field(
                pos, spin, st.types, table, st.box, f)

        self._step = make_step(evaluate, self.cfg, self.masses,
                               self.magnetic)
        self._ff = ForceField(*evaluate(st.pos, st.spin))

    # ==================================================================
    def run(self, n_steps: int, generator: torch.Generator | None = None,
            chunk: int = 20,
            callback: Callable[[SpinLatticeState, ForceField], None]
            | None = None, telemetry=None) -> SpinLatticeState:
        """Advance ``n_steps``, rebuilding the table when the skin test
        trips; returns the final state.  The fused path puts per-chunk
        diagnostics in ``self.trace`` and forwards ``telemetry`` to
        ``Engine.run``; ``callback(state, forces)`` runs after every chunk
        on both paths."""
        if not self._fused:
            if telemetry is not None:
                raise ValueError("telemetry requires the fused path")
            return self._run_legacy(n_steps, generator, chunk, callback)

        self._engine.state = self.state   # honor a caller-swapped state
        cb = None
        if callback is not None:
            def cb(engine):
                self._pull()
                callback(self.state, self._ff)
                engine.state = self.state  # the callback may swap it
        self._engine.run(n_steps, generator, chunk=chunk, field=self.field,
                         callback=cb, telemetry=telemetry)
        self._pull()
        tr = self._engine.trace
        if tr is not None:
            self.trace = ChunkTrace(
                time=tr.time, energy=tr.values["energy"],
                kinetic=tr.values["kinetic"],
                magnetization=tr.values["magnetization"],
                charge=tr.values["charge"])
        return self.state

    def _run_legacy(self, n_steps, generator, chunk, callback):
        done = 0
        while done < n_steps:
            n = min(chunk, n_steps - done)
            if bool(needs_rebuild(self.table, self.state.pos, self.state.box,
                                  self.skin)):
                self._legacy_rebuilds += 1
                self._refresh()
            for _ in range(n):
                self.state, self._ff = self._step(self.state, self._ff,
                                                  generator)
            done += n
            if callback is not None:
                callback(self.state, self._ff)
        return self.state

    @property
    def energy(self) -> float:
        return float(self._ff.energy)


class DomainChunkTrace(NamedTuple):
    """Per-chunk diagnostics of the Sharded plan (C chunks)."""

    time: np.ndarray           # (C,) ps at chunk ends
    energy: np.ndarray         # (C,) potential energy [eV]
    kinetic: np.ndarray        # (C,) lattice kinetic energy [eV]
    magnetization: np.ndarray  # (C, 3) mean spin over magnetic sites


@dataclasses.dataclass
class SimulationSharded:
    """Domain-decomposed twin of :class:`Simulation`: a facade over the
    :class:`~repro_torch.md.engine.Engine` with a
    :class:`~repro_torch.parallel.plan.Sharded` plan.  Every rank of the
    mesh constructs it with the same flat input state and runs it with its
    own generator; one fused halo per drift, the reaction fold (or, with
    ``use_kernel=True``, the q_Fp adjoint halo between K1 and K2), cell
    migration at rebuilds, and a cell overflow raised at the chunk boundary
    where it is detected.  ``state`` comes back in the original atom order
    on every rank.  ``replicas > 0`` composes a leading replica axis with
    the spatial mesh (``mesh`` may carry a ``"replica"`` dimension): each
    rank then runs with one generator per local replica, ``temperature``
    may be (R,) and ``field`` (R, 3), and ``state`` / the trace carry the
    replica axis."""

    potential: Any                     # .pair_energies / .site_moments
    cfg: IntegratorConfig
    state: SpinLatticeState            # flat (N, ...) input state
    masses: torch.Tensor               # (n_types,)
    magnetic: torch.Tensor             # (n_types,) bool
    cutoff: float
    capacity: int = 32                 # per-atom neighbor capacity M
    skin: float = 0.5
    cells: tuple | None = None         # global cell grid (None -> auto)
    cell_capacity: int | None = None   # per-cell capacity K (None -> auto)
    mesh: Any = None                   # DeviceMesh (None -> 1-D "sx")
    axis_map: tuple | None = None      # spatial dim -> mesh dimension name
    halo_mode: str = "auto"            # "ppermute" | "allgather" | "auto"
    field: Any = None                  # (3,) / (R, 3) Tesla, or a Schedule
    replicas: int = 0                  # replicas x domain plan (0: one)
    device: Any = "cuda"
    trace: DomainChunkTrace | None = None

    def __post_init__(self):
        from repro_torch.parallel.plan import Sharded
        self._engine = Engine(
            potential=self.potential, cfg=self.cfg, state=self.state,
            masses=self.masses, magnetic=self.magnetic, cutoff=self.cutoff,
            plan=Sharded(mesh=self.mesh, axis_map=self.axis_map,
                         halo_mode=self.halo_mode, cells=self.cells,
                         cell_capacity=self.cell_capacity,
                         replicas=self.replicas),
            field=self.field,
            observables=("energy", "kinetic", "magnetization"),
            capacity=self.capacity, skin=self.skin, device=self.device)
        rp = self._engine._rplan
        self.mesh, self.axis_map = rp.mesh, rp.axis_map
        self._pull()

    def _pull(self):
        self.state = self._engine.state
        self._ff = self._engine._ff

    @property
    def _dspec(self):
        return self._engine._rplan.dspec

    @property
    def n_rebuilds(self) -> int:
        return self._engine.n_rebuilds

    @property
    def n_migrated(self) -> int:
        """Atoms that changed link cell across all rebuilds."""
        return self._engine.n_migrated

    @property
    def energy(self) -> float:
        return self._engine.energy

    @property
    def halo_ledger(self):
        """The engine's halo exchange ledger."""
        return self._engine.halo_ledger

    def _check_dropped(self):
        self._engine._check_dropped()

    def run(self, n_steps: int, generator=None,
            chunk: int = 20, temperature=None, telemetry=None):
        """Advance ``n_steps``; ``temperature`` (K, (R,) K or a Schedule)
        and ``self.field`` are run-time arguments; ``generator`` is this
        rank's (a list of one per local replica with replicas).  Per-chunk diagnostics land
        in ``self.trace``; returns the final state in the original atom
        order."""
        self._engine.run(n_steps, generator, chunk=chunk,
                         temperature=temperature, field=self.field,
                         telemetry=telemetry)
        self._pull()
        tr = self._engine.trace
        if tr is not None:
            self.trace = DomainChunkTrace(
                time=tr.time, energy=tr.values["energy"],
                kinetic=tr.values["kinetic"],
                magnetization=tr.values["magnetization"])
        return self.state
