"""Metal-style units (LAMMPS convention) used throughout the MD stack
(a copy of ``repro.utils.units``).

length  : Angstrom
time    : picosecond
energy  : eV
mass    : g/mol  (so that F = m a holds with the constants below)
temperature : K
magnetic moment : mu_B (Bohr magneton)
magnetic field  : Tesla
"""
from __future__ import annotations

# Boltzmann constant [eV/K]
KB = 8.617333262e-5
# conversion so that  a [A/ps^2] = F [eV/A] / m [g/mol] * MVV2E^-1
# 1 eV = 1.0364269e-4 (g/mol)(A/ps)^2  ->  F/m in A/ps^2 needs 1/1.0364e-4
MVV2E = 1.0364269e-4  # (g/mol)(A/ps)^2 per eV
FORCE2ACC = 1.0 / MVV2E  # multiply F[eV/A]/m[g/mol] by this to get A/ps^2

# gyromagnetic ratio of electron spin, in rad/(ps*T)
GYRO = 0.17608596  # |gamma_e| = 1.76086e11 rad/(s*T) = 0.176086 rad/(ps*T)
# Bohr magneton in eV/T
MU_B = 5.7883818060e-5

# FeGe constants
FEGE_A = 4.700        # B20 lattice constant [A]
MASS_FE = 55.845      # g/mol
MASS_GE = 72.630      # g/mol
FEGE_TC = 278.0       # K, helimagnetic ordering temperature
FEGE_HELIX_PITCH = 700.0  # A (~70 nm helix period; 57.3 nm in paper Fig. 4)
