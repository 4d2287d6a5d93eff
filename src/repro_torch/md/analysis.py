"""Magnetic-texture analysis: magnetization and the Berg-Luscher topological
charge (port of ``repro.md.analysis``; the helix pitch is not ported yet).
"""
from __future__ import annotations

import math

import torch


def magnetization(spin: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean spin vector over magnetic sites."""
    if mask is not None:
        w = mask.to(spin.dtype)[:, None]
        return torch.sum(spin * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
    return torch.mean(spin, dim=0)


def topological_charge_grid(s: torch.Tensor) -> torch.Tensor:
    """Berg-Luscher topological charge of a 2-D grid of unit spins (nx,ny,3):
    Q = 1/(4pi) sum over plaquettes of the signed solid angle; Q ~ -1 per
    (Bloch) skyrmion. Periodic boundaries."""
    s2 = torch.roll(s, -1, dims=0)
    s3 = torch.roll(s, -1, dims=1)
    s4 = torch.roll(s2, -1, dims=1)

    def solid_angle(a, b, c):
        num = torch.sum(a * torch.linalg.cross(b, c, dim=-1), dim=-1)
        den = (1.0 + torch.sum(a * b, dim=-1) + torch.sum(b * c, dim=-1)
               + torch.sum(a * c, dim=-1))
        return 2.0 * torch.atan2(num, den)

    omega = solid_angle(s, s2, s4) + solid_angle(s, s4, s3)
    return torch.sum(omega) / (4.0 * math.pi)


def accumulate_spin_grid(pos: torch.Tensor, spin: torch.Tensor,
                         box: torch.Tensor, grid: tuple[int, int] = (32, 32),
                         plane: tuple[int, int] = (0, 1),
                         weight: torch.Tensor | None = None) -> torch.Tensor:
    """Raw per-cell spin sums (G0*G1, 3) on the projection plane."""
    ax, ay = plane
    ix = torch.clamp((pos[:, ax] / box[ax] * grid[0]).to(torch.int64),
                     0, grid[0] - 1)
    iy = torch.clamp((pos[:, ay] / box[ay] * grid[1]).to(torch.int64),
                     0, grid[1] - 1)
    s = spin if weight is None else spin * weight[:, None].to(spin.dtype)
    acc = torch.zeros((grid[0] * grid[1], 3), dtype=spin.dtype,
                      device=spin.device)
    return acc.index_add_(0, ix * grid[1] + iy, s)


def charge_from_grid(acc: torch.Tensor,
                     grid: tuple[int, int] = (32, 32)) -> torch.Tensor:
    """Berg-Luscher charge from raw per-cell spin sums; empty cells read +z
    so they add no spurious charge."""
    nrm = torch.linalg.norm(acc, dim=-1, keepdim=True)
    full = nrm > 1e-12
    s = acc / torch.where(full, nrm, torch.ones_like(nrm))
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=acc.dtype, device=acc.device)
    s = torch.where(full, s, zhat)
    return topological_charge_grid(s.reshape(grid[0], grid[1], 3))


def topological_charge(pos: torch.Tensor, spin: torch.Tensor,
                       box: torch.Tensor, grid: tuple[int, int] = (32, 32),
                       plane: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Topological charge of the texture projected on a plane (default x-y)."""
    return charge_from_grid(
        accumulate_spin_grid(pos, spin, box, grid, plane), grid)


def skyrmion_count(charge: torch.Tensor) -> torch.Tensor:
    """Integer skyrmion-count estimate |Q| rounded."""
    return torch.round(torch.abs(charge))
