"""Crystal-lattice builders for spin-lattice dynamics (numpy; a copy of
``repro.md.lattice``).

The paper simulates B20 FeGe (space group P2_1 3, the chiral cubic structure
whose broken inversion symmetry produces the bulk Dzyaloshinskii-Moriya
interaction).  We provide the full 8-atom B20 cell (4 Fe + 4 Ge) and a
simple-cubic effective lattice (one magnetic site per cell) used for cheap
physics validation where only the Fe sublattice topology matters.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.utils import units

# B20 internal coordinates (Wyckoff 4a, x,x,x family)
_U_FE = 0.1352
_U_GE = 0.8414


def _b20_basis(u: float) -> np.ndarray:
    return np.array(
        [
            [u, u, u],
            [0.5 + u, 0.5 - u, 1.0 - u],
            [1.0 - u, 0.5 + u, 0.5 - u],
            [0.5 - u, 1.0 - u, 0.5 + u],
        ]
    ) % 1.0


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A periodic crystal: fractional basis + species + cubic lattice const."""

    a: float                      # lattice constant [A]
    frac: np.ndarray              # (n_basis, 3) fractional coordinates
    species: np.ndarray           # (n_basis,) int type ids
    magnetic: np.ndarray          # (n_basis,) bool - carries a spin
    type_names: tuple[str, ...]
    masses: np.ndarray            # (n_types,) g/mol
    moments: np.ndarray           # (n_types,) mu_B per atom (0 if nonmagnetic)

    @property
    def n_basis(self) -> int:
        return self.frac.shape[0]

    def supercell(self, nx: int, ny: int, nz: int):
        """Replicate to an (nx,ny,nz) supercell.

        Returns (positions (N,3) [A], types (N,), box (3,) [A]).
        Ordering is cell-major so a site's cell index is ``i // n_basis``.
        """
        cells = np.stack(
            np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"),
            axis=-1,
        ).reshape(-1, 3)
        pos = (cells[:, None, :] + self.frac[None, :, :]).reshape(-1, 3) * self.a
        types = np.tile(self.species, cells.shape[0])
        box = np.array([nx, ny, nz], dtype=np.float64) * self.a
        return pos.astype(np.float64), types.astype(np.int32), box


def b20_fege(a: float = units.FEGE_A) -> Lattice:
    """B20 FeGe: 4 Fe (magnetic) + 4 Ge per cubic cell."""
    frac = np.concatenate([_b20_basis(_U_FE), _b20_basis(_U_GE)], axis=0)
    species = np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=np.int32)
    magnetic = np.array([True] * 4 + [False] * 4)
    return Lattice(
        a=a,
        frac=frac,
        species=species,
        magnetic=magnetic,
        type_names=("Fe", "Ge"),
        masses=np.array([units.MASS_FE, units.MASS_GE]),
        moments=np.array([1.16, 0.0]),  # ~1.16 mu_B/Fe in FeGe
    )


def simple_cubic(a: float = units.FEGE_A, moment: float = 1.16) -> Lattice:
    """One magnetic site per cubic cell - effective lattice for spin physics."""
    return Lattice(
        a=a,
        frac=np.zeros((1, 3)),
        species=np.zeros((1,), dtype=np.int32),
        magnetic=np.array([True]),
        type_names=("Fe",),
        masses=np.array([units.MASS_FE]),
        moments=np.array([moment]),
    )


def min_image(dr: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Minimum-image displacement for an orthorhombic periodic box."""
    return dr - box * np.round(dr / box)
