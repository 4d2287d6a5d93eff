"""fege-spinlattice: coupled NEP-SPIN spin-lattice dynamics of B20 FeGe
(port of ``repro.configs.fege_spinlattice``), the single-device run that
``chip_smoke.py`` drives, and the ensemble presets.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.descriptor import NEPSpinSpec


@dataclasses.dataclass(frozen=True)
class MDConfig:
    name: str
    spec: NEPSpinSpec
    # per-DEVICE cell grid of the sharded layout; global grid = cells * devices
    cells_per_device: tuple[int, int, int]
    cell_capacity: int
    cell_size: float          # A (>= cutoff)
    dtype: str = "float32"
    dt: float = 1.0e-3        # ps

    @property
    def atoms_per_device(self) -> int:
        cx, cy, cz = self.cells_per_device
        return cx * cy * cz * self.cell_capacity


def config() -> MDConfig:
    """Production width: the NEP-SPIN spec every run of this model uses."""
    return MDConfig(
        name="fege-spinlattice",
        spec=NEPSpinSpec(cutoff=5.0, basis_size=8, n_rad=6, n_ang=4,
                         l_max=4, n_spin=4, n_types=2, hidden=32),
        cells_per_device=(16, 16, 16),
        cell_capacity=16,
        cell_size=5.5,
    )


def smoke_config() -> MDConfig:
    return MDConfig(
        name="fege-spinlattice-smoke",
        spec=NEPSpinSpec(cutoff=5.0, basis_size=6, n_rad=4, n_ang=2,
                         l_max=2, n_spin=2, n_types=2, hidden=16),
        cells_per_device=(4, 4, 4),
        cell_capacity=10,
        cell_size=5.5,
        dtype="float64",
    )


@dataclasses.dataclass(frozen=True)
class SingleDeviceRun:
    """One flat single-device MD run of B20 FeGe at the production spec."""

    unit_cells: tuple[int, int, int] = (32, 32, 32)   # 8 atoms per cell
    capacity: int = 64          # neighbors per atom (55 inside rc + skin)
    cell_capacity: int = 32     # atoms per linked cell (<= 18 on the lattice)
    skin: float = 0.5
    dt: float = 1.0e-3          # ps
    temperature: float = 300.0  # K, runtime argument
    lattice_gamma: float = 2.0  # 1/ps
    spin_alpha: float = 0.1
    field: tuple[float, float, float] = (0.0, 0.0, 0.2)   # Tesla
    chunks: int = 3
    chunk: int = 20
    dtype: str = "float32"

    @property
    def n_atoms(self) -> int:
        cx, cy, cz = self.unit_cells
        return 8 * cx * cy * cz


def main_path() -> SingleDeviceRun:
    """262,144 atoms (131,072 Fe spins), 3 chunks x 20 steps at 300 K."""
    return SingleDeviceRun()


# ---------------------------------------------------------------------------
# Ensemble presets (repro_torch.ensemble): replica counts, protocols and
# (T, B) grids for the paper's scenario workloads.  Reduced-scale parameters
# use the strong-DMI effective lattice of launch/skyrmion_nucleation.py so
# textures fit a small box; production parameters target FeGe proper
# (Tc ~ 278 K, 0.1-0.2 T, Fig. 9).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    name: str
    n_replicas: int
    n_cells: tuple[int, int, int]     # supercell of the effective lattice
    n_steps: int
    chunk: int                        # steps per chunk
    dt: float                         # ps
    spin_alpha: float
    lattice_gamma: float              # 1/ps
    # field-cooling protocol (Fig. 9): hold hot -> ramp down -> hold cold
    t_hot: float                      # K
    t_cold: float                     # K
    b_field: float                    # Tesla, along +z
    hold_frac: float = 0.25           # fraction of the run spent hot
    ramp_frac: float = 0.5            # fraction spent ramping down
    # (T, B) sweep grid for repro_torch.launch.sweep
    sweep_temperatures: tuple[float, ...] = ()
    sweep_fields: tuple[float, ...] = ()

    def schedules(self):
        """(temperature, field) Schedules for the field-cooling protocol."""
        from repro_torch.ensemble import protocol
        total = self.n_steps * self.dt
        return protocol.field_cooling(
            self.t_hot, self.t_cold, self.b_field,
            t_hold=self.hold_frac * total, t_ramp=self.ramp_frac * total,
            t_final=max(0.0, 1.0 - self.hold_frac - self.ramp_frac) * total)


def nucleation_ensemble() -> EnsembleConfig:
    """Fig.-9 field cooling at reduced scale: 8 replicas of a thin film."""
    return EnsembleConfig(
        name="fege-nucleation-ensemble", n_replicas=8, n_cells=(32, 32, 1),
        n_steps=2000, chunk=100, dt=4e-3, spin_alpha=0.1, lattice_gamma=2.0,
        t_hot=95.0, t_cold=20.0, b_field=25.0,
        sweep_temperatures=(40.0, 95.0, 150.0),
        sweep_fields=(0.0, 15.0, 30.0))


def nucleation_ensemble_smoke() -> EnsembleConfig:
    """CI-sized: 4 replicas, a few chunks, same protocol shape."""
    return EnsembleConfig(
        name="fege-nucleation-ensemble-smoke", n_replicas=4,
        n_cells=(16, 16, 1), n_steps=300, chunk=50, dt=4e-3,
        spin_alpha=0.1, lattice_gamma=2.0,
        t_hot=95.0, t_cold=20.0, b_field=25.0,
        sweep_temperatures=(40.0, 95.0), sweep_fields=(0.0, 25.0))
