"""NEP-SPIN local descriptor in plain PyTorch (port of
``repro.core.descriptor``).

Chebyshev radial / Legendre angular NEP descriptor with three groups of
magnetic channels: onsite |S_i| features; pairwise Heisenberg, DMI and
pseudo-dipolar carriers; and the directional accumulators V_n = sum g_n S_j,
W_n = sum g_n rhat contracted to V.V, V.S_i and W.V.  Every function is
differentiable by autograd, which makes this module (with
``core.potential``) the oracle of the hand-written kernels.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class NEPSpinSpec:
    """Hyperparameters of the NEP-SPIN descriptor + network."""

    cutoff: float = 5.0         # radial cutoff [A]
    basis_size: int = 8         # Chebyshev basis functions per channel (K)
    n_rad: int = 6              # structural radial channels
    n_ang: int = 4              # structural angular channels
    l_max: int = 4              # Legendre order for angular channels
    n_spin: int = 4             # magnetic radial-carrier channels
    n_onsite: int = 3           # onsite |S| Chebyshev features
    n_types: int = 2            # chemical species (Fe, Ge)
    hidden: int = 32            # MLP hidden width
    spin: bool = True           # include magnetic channels

    @property
    def n_desc(self) -> int:
        n = self.n_rad + self.n_ang * self.l_max
        if self.spin:
            n += self.n_onsite + 3 * self.n_spin + 3 * self.n_spin
        return n


# Legendre polynomials P_l(t) coefficients in powers of t, l = 0..4
_LEGENDRE = {
    0: {0: 1.0},
    1: {1: 1.0},
    2: {0: -0.5, 2: 1.5},
    3: {1: -1.5, 3: 2.5},
    4: {0: 0.375, 2: -3.75, 4: 4.375},
}

# multinomial monomial tables: (u.v)^p = sum_c w_c mono_c(u) mono_c(v)
# each entry: list of (exponents (ex,ey,ez), weight)
_MONO = {
    0: [((0, 0, 0), 1.0)],
    1: [((1, 0, 0), 1.0), ((0, 1, 0), 1.0), ((0, 0, 1), 1.0)],
    2: [((2, 0, 0), 1.0), ((0, 2, 0), 1.0), ((0, 0, 2), 1.0),
        ((1, 1, 0), 2.0), ((1, 0, 1), 2.0), ((0, 1, 1), 2.0)],
    3: [((3, 0, 0), 1.0), ((0, 3, 0), 1.0), ((0, 0, 3), 1.0),
        ((2, 1, 0), 3.0), ((2, 0, 1), 3.0), ((1, 2, 0), 3.0),
        ((0, 2, 1), 3.0), ((1, 0, 2), 3.0), ((0, 1, 2), 3.0),
        ((1, 1, 1), 6.0)],
    4: [((4, 0, 0), 1.0), ((0, 4, 0), 1.0), ((0, 0, 4), 1.0),
        ((3, 1, 0), 4.0), ((3, 0, 1), 4.0), ((1, 3, 0), 4.0),
        ((0, 3, 1), 4.0), ((1, 0, 3), 4.0), ((0, 1, 3), 4.0),
        ((2, 2, 0), 6.0), ((2, 0, 2), 6.0), ((0, 2, 2), 6.0),
        ((2, 1, 1), 12.0), ((1, 2, 1), 12.0), ((1, 1, 2), 12.0)],
}


def _monomials(u: torch.Tensor, p: int) -> torch.Tensor:
    """Degree-p monomial components of vectors u (..., 3) -> (..., C_p)."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([(x ** ex) * (y ** ey) * (z ** ez)
                        for (ex, ey, ez), _ in _MONO[p]], dim=-1)


def cutoff_fn(r: torch.Tensor, rc: float) -> torch.Tensor:
    """Smooth cosine cutoff: fc(rc)=0, fc'(rc)=0."""
    x = torch.clamp(r / rc, 0.0, 1.0)
    return 0.5 * (1.0 + torch.cos(math.pi * x))


def chebyshev_basis(r: torch.Tensor, rc: float, k: int) -> torch.Tensor:
    """NEP radial basis f_k(r) = 0.5 (T_k(x)+1) fc(r), x = 2(r/rc-1)^2 - 1.
    Returns (..., k)."""
    x = 2.0 * torch.square(torch.clamp(r / rc, 0.0, 1.0) - 1.0) - 1.0
    fc = cutoff_fn(r, rc)
    tkm1 = torch.ones_like(x)
    tk = x
    out = [tkm1]
    for _ in range(1, k):
        out.append(tk)
        tkm1, tk = tk, 2.0 * x * tk - tkm1
    basis = torch.stack(out[:k], dim=-1)
    return 0.5 * (basis + 1.0) * fc[..., None]


def _radial_g(coeffs: torch.Tensor, fk: torch.Tensor, ti: torch.Tensor,
              tj: torch.Tensor) -> torch.Tensor:
    """g_n(r_ij) = sum_k c[ti,tj,n,k] f_k(r_ij), with the per-pair type
    dispatch as a direct index into the coefficients.

    coeffs: (T, T, n, K); fk: (..., M, K); ti: (...,); tj: (..., M).
    Returns (..., M, n).
    """
    c = coeffs[ti.long()[..., None], tj.long()]          # (..., M, n, K)
    return torch.einsum("...mk,...mnk->...mn", fk, c)


def init_accumulators(spec: NEPSpinSpec, lead_shape: tuple[int, ...],
                      dtype, device=None) -> dict:
    """Zero per-atom channel accumulators."""
    def z(*tail):
        return torch.zeros((*lead_shape, *tail), dtype=dtype, device=device)

    acc = {"rad": z(spec.n_rad),
           **{f"ang{p}": z(spec.n_ang, len(_MONO[p]))
              for p in range(spec.l_max + 1)}}
    if spec.spin:
        acc.update(sp_dot=z(spec.n_spin), sp_dmi=z(spec.n_spin),
                   sp_pd=z(spec.n_spin), sp_v=z(spec.n_spin, 3),
                   sp_w=z(spec.n_spin, 3))
    return acc


def accumulate(
    spec: NEPSpinSpec,
    desc_params: dict,
    acc: dict,
    dr: torch.Tensor,      # (..., M, 3) displacements r_j - r_i
    dist: torch.Tensor,    # (..., M)
    mask: torch.Tensor,    # (..., M) bool
    ti: torch.Tensor,      # (...,) self types
    tj: torch.Tensor,      # (..., M) neighbor types
    si: torch.Tensor,      # (..., 3) self spins
    sj: torch.Tensor,      # (..., M, 3) neighbor spins
) -> dict:
    """Add one neighbor block's contributions to the accumulators."""
    m = mask.to(dr.dtype)
    fk = chebyshev_basis(dist, spec.cutoff, spec.basis_size) * m[..., None]
    rhat = dr / dist[..., None]
    out = dict(acc)

    g_rad = _radial_g(desc_params["c_rad"], fk, ti, tj)
    out["rad"] = acc["rad"] + torch.sum(g_rad, dim=-2)

    g_ang = _radial_g(desc_params["c_ang"], fk, ti, tj)
    for p in range(spec.l_max + 1):
        mono = _monomials(rhat, p)                            # (..., M, C)
        out[f"ang{p}"] = acc[f"ang{p}"] + torch.einsum(
            "...mj,...mc->...jc", g_ang, mono)

    if spec.spin:
        g_sp = _radial_g(desc_params["c_spin"], fk, ti, tj)
        si_b = si[..., None, :].expand_as(sj)
        dot_ss = torch.sum(si_b * sj, dim=-1)
        dmi = torch.sum(torch.linalg.cross(si_b, sj, dim=-1) * rhat, dim=-1)
        pd = torch.sum(si_b * rhat, dim=-1) * torch.sum(sj * rhat, dim=-1)
        out["sp_dot"] = acc["sp_dot"] + torch.einsum("...mj,...m->...j",
                                                     g_sp, dot_ss)
        out["sp_dmi"] = acc["sp_dmi"] + torch.einsum("...mj,...m->...j",
                                                     g_sp, dmi)
        out["sp_pd"] = acc["sp_pd"] + torch.einsum("...mj,...m->...j",
                                                   g_sp, pd)
        out["sp_v"] = acc["sp_v"] + torch.einsum("...mj,...md->...jd",
                                                 g_sp, sj)
        out["sp_w"] = acc["sp_w"] + torch.einsum("...mj,...md->...jd",
                                                 g_sp, rhat)
    return out


def finalize(spec: NEPSpinSpec, acc: dict, si: torch.Tensor) -> torch.Tensor:
    """Contract accumulators into the invariant descriptor (..., n_desc)."""
    feats = [acc["rad"]]
    mpow = {}
    for p in range(spec.l_max + 1):
        a2 = acc[f"ang{p}"] ** 2
        mpow[p] = sum(w * a2[..., c] for c, (_, w) in enumerate(_MONO[p]))
    for l in range(1, spec.l_max + 1):
        feats.append(sum(coef * mpow[p] for p, coef in _LEGENDRE[l].items()))

    if spec.spin:
        smag = torch.sqrt(torch.sum(si * si, dim=-1) + 1e-30)
        ons = [smag]
        for _ in range(1, spec.n_onsite):
            ons.append(ons[-1] * smag)
        feats.append(torch.stack(ons, dim=-1))
        feats.append(acc["sp_dot"])
        feats.append(acc["sp_dmi"])
        feats.append(acc["sp_pd"])
        feats.append(torch.sum(acc["sp_v"] ** 2, dim=-1))
        feats.append(torch.einsum("...jd,...d->...j", acc["sp_v"], si))
        feats.append(torch.sum(acc["sp_w"] * acc["sp_v"], dim=-1))

    q = torch.cat(feats, dim=-1)
    if q.shape[-1] != spec.n_desc:
        raise ValueError(f"descriptor width {q.shape[-1]} != {spec.n_desc}")
    return q


def descriptors(spec: NEPSpinSpec, desc_params: dict, dr, dist, mask, ti, tj,
                si, sj) -> torch.Tensor:
    """Per-atom NEP-SPIN descriptor vector. Returns (N, n_desc)."""
    acc = init_accumulators(spec, dr.shape[:-2], dr.dtype, dr.device)
    acc = accumulate(spec, desc_params, acc, dr, dist, mask, ti, tj, si, sj)
    return finalize(spec, acc, si)
