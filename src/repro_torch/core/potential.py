"""NEP-SPIN potential: per-element MLP over the spin-aware descriptor (port of
``repro.core.potential``).

One energy surface E(R, S); forces F = -dE/dR and effective fields
H = -dE/dS are exact derivatives of the same scalar, by autograd here
(:func:`compute` from pre-gathered blocks, :func:`energy_forces_field`
through the gather) and by the hand-written kernels in
:mod:`repro_torch.kernels.nep` when ``use_kernel=True``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.descriptor import NEPSpinSpec, descriptors
from repro_torch.md.neighbor import (NeighborTable, Neighborhood,
                                     compute_from_blocks, compute_replicas,
                                     gather_neighbors)
from repro_torch.utils import units
from repro_torch.utils.device import resolve_device


class NEPSpinParams(NamedTuple):
    """All trainable parameters. Leading axis T = n_types where per-element."""

    c_rad: torch.Tensor    # (T, T, n_rad, K) radial expansion coefficients
    c_ang: torch.Tensor    # (T, T, n_ang, K)
    c_spin: torch.Tensor   # (T, T, n_spin, K)
    w1: torch.Tensor       # (T, n_desc, H)
    b1: torch.Tensor       # (T, H)
    w2: torch.Tensor       # (T, H)
    b2: torch.Tensor       # (T,)
    q_scale: torch.Tensor  # (n_desc,) fixed descriptor normalizer

    def desc_params(self) -> dict:
        return {"c_rad": self.c_rad, "c_ang": self.c_ang,
                "c_spin": self.c_spin}


def init_params(spec: NEPSpinSpec, generator: torch.Generator, *,
                dtype=torch.float32, device="cuda") -> NEPSpinParams:
    """Random parameters with the reference's distributions, drawn from
    ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    T, K, H, D = spec.n_types, spec.basis_size, spec.hidden, spec.n_desc

    def norm(shape, scale):
        return scale * torch.randn(shape, generator=generator, dtype=dtype,
                                   device=dev)

    def sym(c):   # structural carriers are symmetric under i <-> j
        return 0.5 * (c + c.transpose(0, 1))

    c_rad = sym(norm((T, T, spec.n_rad, K), 0.5))
    c_ang = sym(norm((T, T, spec.n_ang, K), 0.5))
    c_spin = sym(norm((T, T, spec.n_spin, K), 0.5))
    w1 = norm((T, D, H), (1.0 / D) ** 0.5)
    w2 = norm((T, H), (1.0 / H) ** 0.5)
    b1 = torch.zeros((T, H), dtype=dtype, device=dev)
    b2 = torch.zeros((T,), dtype=dtype, device=dev)
    return NEPSpinParams(c_rad, c_ang, c_spin, w1, b1, w2, b2,
                         q_scale=torch.ones(D, dtype=dtype, device=dev))


def params_from_jax(arrays, *, device="cuda",
                    dtype=torch.float32) -> NEPSpinParams:
    """Parameters from the reference's ``NEPSpinParams`` leaves given as
    numpy arrays in field order (c_rad, c_ang, c_spin, w1, b1, w2, b2,
    q_scale)."""
    dev = resolve_device(device)
    leaves = [torch.as_tensor(np.array(a), dtype=dtype, device=dev)
              for a in arrays]
    if len(leaves) != len(NEPSpinParams._fields):
        raise ValueError(f"expected {len(NEPSpinParams._fields)} leaves, "
                         f"got {len(leaves)}")
    return NEPSpinParams(*leaves)


def mlp_energy(params: NEPSpinParams, q: torch.Tensor,
               ti: torch.Tensor) -> torch.Tensor:
    """Per-atom energy from descriptor q (N, D): one dense matmul per
    element type, selected per atom."""
    qn = q / params.q_scale
    e = torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)
    for a in range(params.w1.shape[0]):
        h = torch.tanh(qn @ params.w1[a] + params.b1[a])
        e = torch.where(ti == a, h @ params.w2[a] + params.b2[a], e)
    return e


def atom_energies(spec: NEPSpinSpec, params: NEPSpinParams,
                  dr, dist, mask, ti, tj, si, sj) -> torch.Tensor:
    q = descriptors(spec, params.desc_params(), dr, dist, mask, ti, tj, si,
                    sj)
    return mlp_energy(params, q, ti)


def zeeman_moments(moments, types, like: torch.Tensor) -> torch.Tensor:
    """Per-site moment [mu_B] of the Zeeman term (ones when unset)."""
    if moments is None:
        return torch.ones(types.shape, dtype=like.dtype, device=like.device)
    return moments.to(like.dtype)[types.long()]


def _zeeman(spin, types, field, moments) -> torch.Tensor:
    mom = zeeman_moments(moments, types, spin)
    b = torch.as_tensor(field, dtype=spin.dtype, device=spin.device)
    return -units.MU_B * torch.sum(mom[:, None] * spin * b, dim=(-2, -1))


def energy(spec: NEPSpinSpec, params: NEPSpinParams, pos: torch.Tensor,
           spin: torch.Tensor, types: torch.Tensor, table: NeighborTable,
           box: torch.Tensor, field=None, moments=None) -> torch.Tensor:
    """Total energy E(R, S) [eV]; ``field`` (3,) Tesla adds the Zeeman term
    -mu_B * m_t * sum_i S_i . B (the external field is not learned).  A
    batch of configurations (:func:`~repro_torch.md.neighbor.
    gather_neighbors`) gives one energy each, (C,)."""
    dr, dist, sj, tj, mask = gather_neighbors(pos, spin, types, table, box)
    e = torch.sum(atom_energies(spec, params, dr, dist, mask, types, tj, spin,
                                sj), dim=-1)
    if field is not None:
        e = e + _zeeman(spin, types, field, moments)
    return e


def energy_forces_field(spec: NEPSpinSpec, params: NEPSpinParams,
                        pos: torch.Tensor, spin: torch.Tensor,
                        types: torch.Tensor, table: NeighborTable,
                        box: torch.Tensor, field=None, moments=None, *,
                        create_graph: bool = False):
    """(E, F = -dE/dR (N,3) [eV/A], H_eff = -dE/dS (N,3)) by autograd
    through the gather: the whole-evaluation surface.  A batch of
    configurations (``pos``/``spin`` (C, N, 3), ``table`` (C, N, M)) gives
    E (C,) and each configuration's F and H_eff: E_c depends on
    configuration c alone, so the gradient of sum_c E_c is theirs.

    ``create_graph`` keeps the graph of all three, so a loss on the forces
    and fields differentiates into ``params`` (training); without it the
    outputs are detached (MD)."""
    p = pos.detach().requires_grad_(True)
    s = spin.detach().requires_grad_(True)
    with torch.enable_grad():
        e = energy(spec, params, p, s, types, table, box, field, moments)
        g_p, g_s = torch.autograd.grad(torch.sum(e), (p, s),
                                       create_graph=create_graph,
                                       allow_unused=True)
    if g_s is None:             # a spin-free spec without a field
        g_s = torch.zeros_like(spin)
    return (e if create_graph else e.detach()), -g_p, -g_s


def compute(spec: NEPSpinSpec, params: NEPSpinParams, nbh: Neighborhood,
            spin: torch.Tensor, types: torch.Tensor, field=None,
            moments=None, *, plain: bool = False):
    """Gather-once autograd evaluation ``(E, F, H_eff)`` from pre-gathered
    neighbor blocks; ``field`` (3,) Tesla adds the Zeeman term
    -mu_B * m_t * sum_i S_i . B.  ``plain`` sums the pair reactions with
    ``index_add_`` (:func:`~repro_torch.md.neighbor.compute_from_blocks`)."""
    def etot(dr, s, rows):
        dist = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-30)
        e = torch.sum(atom_energies(spec, params, dr, dist, nbh.mask, types,
                                    nbh.tj, s, rows(s)))
        if field is not None:
            e = e + _zeeman(s, types, field, moments)
        return e

    return compute_from_blocks(etot, nbh, spin, plain)


@dataclasses.dataclass(frozen=True)
class NEPSpinPotential:
    """Bound NEP-SPIN surface: (spec, params) with the engine-facing API.

    ``compute`` is the gather-once surface the MD loop calls,
    ``energy_forces_field`` the whole evaluation of the legacy driver;
    ``use_kernel`` routes both through the hand-written kernels
    (:mod:`repro_torch.kernels.nep.ops`) instead of autograd.
    """

    spec: NEPSpinSpec
    params: NEPSpinParams
    moments: torch.Tensor | None = None   # (n_types,) mu_B per type
    use_kernel: bool = False

    @property
    def pair_scatter(self) -> bool:
        """Whether ``compute`` sums pair reactions through the table's
        transpose (autograd); K2 has no reverse scatter."""
        return not self.use_kernel

    def energy_forces_field(self, pos, spin, types, table, box, field=None):
        if self.use_kernel:
            from repro_torch.kernels.nep.ops import nep_energy_forces_field
            return nep_energy_forces_field(self.spec, self.params, pos, spin,
                                           types, table, box, field,
                                           self.moments)
        return energy_forces_field(self.spec, self.params, pos, spin, types,
                                   table, box, field, self.moments)

    def pair_energies(self, dr, dist, mask, ti, tj, si, sj):
        """Per-atom energies from pre-gathered pair blocks (flat (N, M)
        shapes), by autograd-transparent torch ops."""
        return atom_energies(self.spec, self.params, dr, dist, mask, ti, tj,
                             si, sj)

    def site_moments(self, types):
        """Per-site magnetic moment [mu_B] entering the Zeeman term."""
        if self.moments is not None:
            return self.moments[types.long()]
        return torch.ones(types.shape, dtype=torch.float32,
                          device=types.device)

    def compute(self, nbh: Neighborhood, spin, types, field=None):
        """``(E, F, H_eff)`` from pre-gathered blocks; a replica batch
        (``spin`` (R, N, 3), ``field`` (R, 3)) goes through K1 and K2 once
        for all replicas with ``use_kernel``, else through autograd one
        replica at a time (:func:`~repro_torch.md.neighbor.compute_replicas`,
        a Python loop)."""
        if self.use_kernel:
            from repro_torch.kernels.nep.ops import nep_compute
            return nep_compute(self.spec, self.params, nbh, spin, types,
                               field, self.moments)
        if spin.dim() == 3:
            return compute_replicas(self.compute, nbh, spin, types, field)
        return compute(self.spec, self.params, nbh, spin, types, field,
                       self.moments)
