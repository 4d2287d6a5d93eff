"""Metal units (LAMMPS convention): A, ps, eV, g/mol, K, mu_B, Tesla."""

KB = 8.617333262e-5          # eV/K
MVV2E = 1.0364269e-4         # (g/mol)(A/ps)^2 per eV
FORCE2ACC = 1.0 / MVV2E      # F [eV/A] / m [g/mol] * this = A/ps^2
GYRO = 0.17608596            # rad/(ps T), |gamma_e|
MU_B = 5.7883818060e-5       # eV/T
