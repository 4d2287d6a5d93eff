"""(T, B) phase-diagram sweep driver (port of ``repro.ensemble.sweep``).

Fans ``n_replicas`` stochastic replicas over every point of a temperature x
field grid as ONE flat replica batch (nT * nB * R replicas, each at its own
constant (T, B)), runs them through the replica engine, and reduces the
per-chunk diagnostics into a :class:`PhaseDiagram`: the helix -> skyrmion
phase map of the paper's Figs. 4/9, resolved as ensemble statistics.

Measurements average over the trailing ``measure_frac`` of chunks (the
leading chunks are burn-in while the thermostats equilibrate each grid
point).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.ensemble.replica import (ReplicaEnsemble, replicate,
                                          spawn_generators)
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.state import SpinLatticeState


class PhaseDiagram(NamedTuple):
    """Ensemble-averaged observables on the (T, B) grid."""

    temperatures: np.ndarray   # (nT,) K
    fields: np.ndarray         # (nB,) Tesla (magnitude along field_axis)
    charge: np.ndarray         # (nT, nB) <Q> over replicas + measure window
    charge_abs: np.ndarray     # (nT, nB) <|Q|> (nucleation activity)
    charge_std: np.ndarray     # (nT, nB) replica std of Q (nucleation spread)
    magnetization: np.ndarray  # (nT, nB) <S_z>
    pitch: np.ndarray          # (nT, nB) helix pitch [A]
    energy: np.ndarray         # (nT, nB) potential energy per replica [eV]
    n_replicas: int

    def summary(self) -> str:
        lines = ["T [K] \\ B [T]  " + "  ".join(f"{b:8.2f}"
                                                for b in self.fields)]
        for i, t in enumerate(self.temperatures):
            cells = "  ".join(f"{self.charge_abs[i, j]:8.3f}"
                              for j in range(len(self.fields)))
            lines.append(f"{t:8.1f}  |Q|= {cells}")
        return "\n".join(lines)


def run_sweep(
    base_state: SpinLatticeState,
    potential: Any,
    cfg: IntegratorConfig,
    masses: torch.Tensor,
    magnetic: torch.Tensor,
    temperatures: Sequence[float],
    fields: Sequence[float],
    *,
    n_replicas: int,
    n_steps: int,
    seed: int,
    cutoff: float,
    capacity: int = 16,
    field_axis: tuple[float, float, float] = (0.0, 0.0, 1.0),
    chunk: int = 100,
    measure_frac: float = 0.5,
    diag_grid: tuple[int, int] = (32, 32),
    callback=None,
    device="cuda",
) -> PhaseDiagram:
    """Run the full (T, B) grid and return the filled :class:`PhaseDiagram`.

    ``base_state`` is a single (flat) state, typically the zero-field helix
    ground state; every grid point gets ``n_replicas`` copies of it that
    differ only in their thermostat noise (one generator each, spawned from
    ``seed``).
    """
    t_grid = np.asarray(temperatures, np.float32)
    b_grid = np.asarray(fields, np.float32)
    nt, nb, r = len(t_grid), len(b_grid), n_replicas
    r_tot = nt * nb * r

    # flat replica batch: index = (it * nB + ib) * R + ir
    t_rep = np.repeat(t_grid, nb * r)                           # (R_tot,)
    axis = np.asarray(field_axis, np.float32)
    b_rep = np.repeat(np.tile(b_grid, nt), r)[:, None] * axis[None, :]

    ens = ReplicaEnsemble(
        potential=potential, cfg=cfg, states=replicate(base_state, r_tot),
        masses=masses, magnetic=magnetic, cutoff=cutoff, capacity=capacity,
        diag_grid=diag_grid, device=device)
    trace = ens.run(n_steps, spawn_generators(seed, r_tot, ens._engine.device),
                    temperature=t_rep, field=b_rep, chunk=chunk,
                    callback=callback)

    n_chunks = trace.charge.shape[0]
    first = min(n_chunks - 1, int(np.ceil(n_chunks * (1.0 - measure_frac))))

    def grid_mean(x, absval=False):  # (C, R_tot) -> (nT, nB)
        win = np.abs(x[first:]) if absval else x[first:]
        return win.mean(axis=0).reshape(nt, nb, r).mean(axis=-1)

    q_win = trace.charge[first:].mean(axis=0).reshape(nt, nb, r)
    return PhaseDiagram(
        temperatures=t_grid, fields=b_grid,
        charge=grid_mean(trace.charge),
        charge_abs=grid_mean(trace.charge, absval=True),
        charge_std=q_win.std(axis=-1),
        magnetization=grid_mean(trace.magnetization),
        pitch=grid_mean(trace.pitch),
        energy=grid_mean(trace.energy),
        n_replicas=r)
