"""Reference spin-lattice Hamiltonian: the classical Heisenberg-DMI baseline
and the training oracle (port of ``repro.core.hamiltonian``).

Model (pair terms smoothly cut off by fc(r)):

  E = sum_pairs V_morse(r)                         lattice (anharmonic)
    - 1/2 sum_pairs J(r)  S_i . S_j                Heisenberg exchange
    - 1/2 sum_pairs D(r)  r_hat . (S_i x S_j)      bulk DMI (B20 chirality)
    + 1/2 sum_pairs Kpd(r) (S_i.r_hat)(S_j.r_hat)  pseudo-dipolar anisotropy
    + sum_i Ka (S_i . n)^2                         single-ion anisotropy
    + sum_i A_L (|S_i|^2 - 1)^2                    Landau longitudinal term
    - mu_B m sum_i S_i . B                         Zeeman

with J(r) = J0 exp(-gamma_J (r - r0)) and D(r) = D0 exp(-gamma_D (r - r0)).
Forces and effective fields are exact derivatives of E by autograd: the
whole evaluation (:meth:`HeisenbergDMIModel.energy_forces_field`)
differentiates through the neighbor gather; the gather-once surface
(:meth:`HeisenbergDMIModel.compute`) differentiates the pre-gathered blocks
and sums the pair reactions deterministically
(:func:`repro_torch.md.neighbor.compute_from_blocks`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.descriptor import cutoff_fn
from repro_torch.md.neighbor import (NeighborTable, Neighborhood,
                                     compute_from_blocks, compute_replicas,
                                     gather_neighbors)
from repro_torch.utils import units


@dataclasses.dataclass(frozen=True)
class HeisenbergDMIModel:
    cutoff: float = 5.0
    r0: float = units.FEGE_A          # equilibrium NN distance [A]
    # lattice (Morse)
    morse_de: float = 0.30            # eV
    morse_alpha: float = 1.4          # 1/A
    # magnetism
    j0: float = 0.0166                # eV  (calibrated to Tc ~ 278 K)
    gamma_j: float = 1.0              # 1/A exchange-distance decay
    d0: float = 7.0e-4                # eV  (D/J ~= 0.042 -> 70 nm pitch)
    gamma_d: float = 1.0
    kpd: float = 0.0                  # pseudo-dipolar strength [eV]
    ka: float = 0.0                   # single-ion anisotropy [eV]
    ka_axis: tuple[float, float, float] = (0.0, 0.0, 1.0)
    landau_a: float = 0.5             # eV, longitudinal stiffness
    moment: float = 1.16              # mu_B per magnetic atom
    magnetic_type: int = 0            # only this type carries spin couplings

    # the gather-once surface sums pair reactions through the table's
    # transpose: the engine builds it with the blocks
    pair_scatter = True

    def pitch(self, a: float | None = None) -> float:
        """Analytic zero-T helix pitch [A] for NN simple-cubic topology."""
        a = a if a is not None else self.r0
        return 2.0 * math.pi * a / math.atan2(self.d0, self.j0)

    # ------------------------------------------------------------------
    def atom_energies(self, dr, dist, mask, ti, tj, si, sj) -> torch.Tensor:
        """Per-atom energy (half of each pair term); shapes as
        :func:`repro_torch.core.descriptor.descriptors`."""
        m = mask.to(dr.dtype)
        fc = cutoff_fn(dist, self.cutoff) * m
        rhat = dr / dist[..., None]

        # lattice: Morse (shifted so V(r0) = -De; fc removes the cutoff jump)
        ex = torch.exp(-self.morse_alpha * (dist - self.r0))
        v_pair = self.morse_de * ((1.0 - ex) ** 2 - 1.0) * fc

        mag_i = (ti == self.magnetic_type).to(dr.dtype)
        mag_j = (tj == self.magnetic_type).to(dr.dtype)
        mag = mag_i[:, None] * mag_j

        jr = self.j0 * torch.exp(-self.gamma_j * (dist - self.r0)) * fc * mag
        dr_ = self.d0 * torch.exp(-self.gamma_d * (dist - self.r0)) * fc * mag

        si_b = si[:, None, :]
        heis = -jr * torch.sum(si_b * sj, dim=-1)
        dmi = -dr_ * torch.sum(
            rhat * torch.linalg.cross(si_b.expand_as(sj), sj, dim=-1), dim=-1)
        pd = (self.kpd * torch.exp(-self.gamma_j * (dist - self.r0)) * fc
              * mag * torch.sum(si_b * rhat, dim=-1)
              * torch.sum(sj * rhat, dim=-1))

        e_pair = 0.5 * torch.sum(v_pair + heis + dmi + pd, dim=1)

        n = torch.tensor(self.ka_axis, dtype=dr.dtype, device=dr.device)
        smag2 = torch.sum(si * si, dim=-1)
        e_onsite = (self.ka * torch.square(si @ n)
                    + self.landau_a * torch.square(smag2 - 1.0)) * mag_i
        return e_pair + e_onsite

    def _zeeman(self, spin, types, field) -> torch.Tensor:
        mag = (types == self.magnetic_type).to(spin.dtype)
        b = torch.as_tensor(field, dtype=spin.dtype, device=spin.device)
        return -units.MU_B * self.moment * torch.sum(mag[:, None] * spin * b)

    def energy(self, pos, spin, types, table: NeighborTable, box,
               field=None) -> torch.Tensor:
        dr, dist, sj, tj, mask = gather_neighbors(pos, spin, types, table,
                                                  box)
        e = torch.sum(self.atom_energies(dr, dist, mask, types, tj, spin, sj))
        if field is not None:
            e = e + self._zeeman(spin, types, field)
        return e

    def energy_forces_field(self, pos, spin, types, table, box, field=None):
        """(E, F = -dE/dR, H_eff = -dE/dS) by autograd through the gather
        (the whole-evaluation surface of the legacy driver)."""
        p = pos.detach().requires_grad_(True)
        s = spin.detach().requires_grad_(True)
        with torch.enable_grad():
            e = self.energy(p, s, types, table, box, field)
            g_p, g_s = torch.autograd.grad(e, (p, s))
        return e.detach(), -g_p, -g_s

    # ------------------------------------------------------------------
    def pair_energies(self, dr, dist, mask, ti, tj, si, sj) -> torch.Tensor:
        """Per-atom energies from pre-gathered pair blocks (flat (N, M)
        shapes): identical math to :meth:`atom_energies`."""
        return self.atom_energies(dr, dist, mask, ti, tj, si, sj)

    def site_moments(self, types) -> torch.Tensor:
        """Per-site magnetic moment [mu_B] entering the Zeeman term."""
        return self.moment * (types == self.magnetic_type).to(torch.float32)

    # ------------------------------------------------------------------
    def compute(self, nbh: Neighborhood, spin, types, field=None, *,
                plain: bool = False):
        """Gather-once evaluation ``(E, F, H_eff)`` from pre-gathered blocks:
        positions enter only through ``nbh.dr``; neighbor spins are gathered
        here, since spins change between evaluations at fixed positions.
        ``plain`` sums the pair reactions with ``index_add_`` (see
        :func:`~repro_torch.md.neighbor.compute_from_blocks`).  A replica
        batch (``spin`` (R, N, 3), ``field`` (R, 3)) is evaluated one
        replica at a time, in a Python loop
        (:func:`~repro_torch.md.neighbor.compute_replicas`)."""
        if spin.dim() == 3:
            return compute_replicas(
                lambda *a: self.compute(*a, plain=plain), nbh, spin, types,
                field)

        def etot(dr, s, rows):
            dist = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-30)
            e = torch.sum(self.atom_energies(dr, dist, nbh.mask, types,
                                             nbh.tj, s, rows(s)))
            if field is not None:
                e = e + self._zeeman(s, types, field)
            return e

        return compute_from_blocks(etot, nbh, spin, plain)
