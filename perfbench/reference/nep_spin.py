"""NEP-SPIN energy, forces and effective fields in plain PyTorch.

A frozen copy of the published NEP-SPIN equations (arXiv:2606.14073, the
"NEP-SPIN potential" section): Chebyshev radial functions times a cosine
cutoff, type-pair coefficients c[ti, tj, n, k] mixing them into radial,
angular (Legendre order <= l_max, through the monomial expansion of
(r_ij . r_ik)^p) and magnetic channels (Heisenberg S_i.S_j, DMI
(S_i x S_j).r_ij, pseudo-dipolar (S_i.r)(S_j.r), the vector accumulators V
= sum g S_j and W = sum g r_ij contracted to V.V, V.S_i and W.V, and
|S_i| powers), then a per-type one-hidden-layer tanh network.  Forces
F = -dE/dR and fields H = -dE/dS are taken by autograd on blocks of atoms
and summed over pairs with ``index_add_``; the Zeeman term
-mu_B m_t S.B is added in closed form.

Every contraction goes through ``Contract``: plain float32 by default, or
with both operands rounded to TF32 (10-bit mantissa, float32 accumulation),
which is the control: the reference in the nearest precision below the
configuration's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.reference.units import MU_B

# Legendre P_l(t) coefficients in powers of t, l = 0..4
LEGENDRE = {0: {0: 1.0}, 1: {1: 1.0}, 2: {0: -0.5, 2: 1.5},
            3: {1: -1.5, 3: 2.5}, 4: {0: 0.375, 2: -3.75, 4: 4.375}}


def monomial_table(p: int):
    """(exponents, multinomial weight) of (u.v)^p = sum_c w_c m_c(u) m_c(v)."""
    out = []
    for ex in range(p, -1, -1):
        for ey in range(p - ex, -1, -1):
            ez = p - ex - ey
            w = math.factorial(p) // (math.factorial(ex) * math.factorial(ey)
                                      * math.factorial(ez))
            out.append(((ex, ey, ez), float(w)))
    return out


@dataclasses.dataclass(frozen=True)
class Spec:
    cutoff: float
    basis_size: int
    n_rad: int
    n_ang: int
    l_max: int
    n_spin: int
    n_onsite: int
    n_types: int
    hidden: int

    @property
    def n_desc(self) -> int:
        return (self.n_rad + self.n_ang * self.l_max + self.n_onsite
                + 6 * self.n_spin)

    @classmethod
    def from_config(cls, pot: dict) -> "Spec":
        return cls(**{f.name: pot[f.name] for f in dataclasses.fields(cls)})


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10-bit mantissa."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


@dataclasses.dataclass(frozen=True)
class Contract:
    """The reference's contractions: float32, or TF32 (the control)."""

    tf32: bool = False

    def __call__(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        if self.tf32:
            a, b = _TF32.apply(a), _TF32.apply(b)
        return torch.einsum(eq, a, b)


def _cheb(r, rc: float, k: int):
    """f_k(r) = 0.5 (T_k(x) + 1) fc(r), x = 2 (r/rc - 1)^2 - 1, (..., k)."""
    u = torch.clamp(r / rc, 0.0, 1.0)
    x = 2.0 * (u - 1.0) ** 2 - 1.0
    fc = 0.5 * (1.0 + torch.cos(math.pi * u))
    t = [torch.ones_like(x), x]
    for _ in range(2, k):
        t.append(2.0 * x * t[-1] - t[-2])
    return 0.5 * (torch.stack(t[:k], dim=-1) + 1.0) * fc[..., None]


def _monomials(u, p: int):
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    return torch.stack([x ** ex * y ** ey * z ** ez
                        for (ex, ey, ez), _ in monomial_table(p)], dim=-1)


def descriptor(spec: Spec, w: dict, dr, mask, ti, tj, si, sj,
               mm: Contract):
    """Per-atom descriptors (B, n_desc) of a block: dr (B, M, 3) = r_j -
    r_i, mask (B, M), ti (B,), tj (B, M), si (B, 3), sj (B, M, 3)."""
    dist = torch.sqrt(torch.sum(dr * dr, dim=-1))
    m = mask.to(dr.dtype)
    fk = _cheb(dist, spec.cutoff, spec.basis_size) * m[..., None]
    rhat = dr / dist[..., None]
    ti_, tj_ = ti.long()[:, None], tj.long()

    def g(name):                          # (B, M, n) = sum_k c f_k
        return mm("bmk,bmnk->bmn", fk, w[name][ti_, tj_])

    feats = [torch.sum(g("c_rad"), dim=1)]
    g_ang = g("c_ang")
    mpow = {}
    for p in range(spec.l_max + 1):
        a = mm("bmj,bmc->bjc", g_ang, _monomials(rhat, p))
        wts = torch.tensor([wt for _, wt in monomial_table(p)],
                           dtype=dr.dtype, device=dr.device)
        mpow[p] = torch.sum(a * a * wts, dim=-1)
    for l in range(1, spec.l_max + 1):
        feats.append(sum(cf * mpow[p] for p, cf in LEGENDRE[l].items()))
    smag = torch.sqrt(torch.sum(si * si, dim=-1) + 1e-30)
    feats.append(torch.stack([smag ** (k + 1) for k in range(spec.n_onsite)],
                             dim=-1))
    g_sp = g("c_spin")
    si_b = si[:, None, :].expand_as(sj)
    dot = torch.sum(si_b * sj, dim=-1)
    dmi = torch.sum(torch.linalg.cross(si_b, sj, dim=-1) * rhat, dim=-1)
    pd = torch.sum(si_b * rhat, dim=-1) * torch.sum(sj * rhat, dim=-1)
    v = mm("bmj,bmd->bjd", g_sp, sj)
    wv = mm("bmj,bmd->bjd", g_sp, rhat)
    feats += [mm("bmj,bm->bj", g_sp, dot), mm("bmj,bm->bj", g_sp, dmi),
              mm("bmj,bm->bj", g_sp, pd), torch.sum(v * v, dim=-1),
              torch.einsum("bjd,bd->bj", v, si), torch.sum(wv * v, dim=-1)]
    return torch.cat(feats, dim=-1)


def atom_energies(spec: Spec, w: dict, dr, mask, ti, tj, si, sj,
                  mm: Contract):
    """Per-atom energies of a block (arguments of :func:`descriptor`):
    the per-type tanh network over the scaled descriptor."""
    q = descriptor(spec, w, dr, mask, ti, tj, si, sj, mm) / w["q_scale"]
    e = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
    for a in range(spec.n_types):
        h = torch.tanh(mm("bd,dh->bh", q, w["w1"][a]) + w["b1"][a])
        e = torch.where(ti == a, mm("bh,h->b", h, w["w2"][a]) + w["b2"][a],
                        e)
    return e


def evaluate(spec: Spec, w: dict, pos, spin, types, box, idx, mask,
             moments, field, mm: Contract, block: int = 8192):
    """``(E, F (N, 3), H (N, 3))`` of one configuration from a neighbor
    list (``idx``, ``mask``: :func:`perfbench.reference.neighbors.
    neighbor_list`)."""
    n = pos.shape[0]
    force = torch.zeros_like(pos)
    heff = torch.zeros_like(spin)
    energy = torch.zeros((), dtype=torch.float64, device=pos.device)
    far = torch.tensor([2.0 * spec.cutoff, 0.0, 0.0], dtype=pos.dtype,
                       device=pos.device)
    for lo in range(0, n, block):
        rows = slice(lo, min(lo + block, n))
        j = idx[rows]
        mk = mask[rows]
        dr = pos[j] - pos[rows][:, None, :]
        dr = dr - box * torch.round(dr / box)
        dr = torch.where(mk[..., None], dr, far).detach().requires_grad_()
        si = spin[rows].detach().clone().requires_grad_()
        sj = spin[j].detach().requires_grad_()
        with torch.enable_grad():
            e = atom_energies(spec, w, dr, mk, types[rows], types[j], si, sj,
                              mm)
            g_dr, g_si, g_sj = torch.autograd.grad(e.sum(), (dr, si, sj))
        g_dr = torch.where(mk[..., None], g_dr, torch.zeros_like(g_dr))
        g_sj = torch.where(mk[..., None], g_sj, torch.zeros_like(g_sj))
        energy = energy + e.detach().double().sum()
        force[rows] += g_dr.sum(dim=1)
        force.index_add_(0, j.reshape(-1), -g_dr.reshape(-1, 3))
        heff[rows] -= g_si
        heff.index_add_(0, j.reshape(-1), -g_sj.reshape(-1, 3))
    mom = moments[types.long()][:, None]
    b = field.to(pos.dtype)
    energy = energy - MU_B * torch.sum((mom * spin * b).double())
    heff = heff + MU_B * mom * b
    return energy, force, heff
