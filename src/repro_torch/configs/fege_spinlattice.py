"""fege-spinlattice: coupled NEP-SPIN spin-lattice dynamics of B20 FeGe
(port of ``repro.configs.fege_spinlattice``), plus the single-device run
that ``chip_smoke.py`` drives.
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
