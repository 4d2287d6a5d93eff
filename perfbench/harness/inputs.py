"""The inputs of a run, made from ``--seed`` on the device: the B20 FeGe
crystal with its velocities and spins, and the seeds of the weights
(:mod:`perfbench.models`) and of the thermostats' noise.  Both the program
and the reference take these tensors as they are; the same seed gives the
same inputs.
"""
from __future__ import annotations

import torch

from perfbench.reference.units import KB, MVV2E

# B20 internal coordinates (Wyckoff 4a, x x x): Fe u = 0.1352, Ge 0.8414
_U = {"Fe": 0.1352, "Ge": 0.8414}
MASK64 = (1 << 62) - 1
# a crystal started at its energy minimum shares the kinetic energy with
# the potential, so the lattice is drawn at HEAT_FACTOR x T to land near T
HEAT_FACTOR = 2.0


def _b20_basis(u: float):
    return [[u, u, u], [0.5 + u, 0.5 - u, 1.0 - u],
            [1.0 - u, 0.5 + u, 0.5 - u], [0.5 - u, 1.0 - u, 0.5 + u]]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one input stream of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 64 + stream) & MASK64)


def crystal(lattice: dict, cells, device):
    """``(pos (N, 3), types (N,) int32, box (3,))`` of B20 FeGe, cell-major
    (eight atoms a unit cell: four Fe, type 0, then four Ge, type 1)."""
    frac = torch.tensor(_b20_basis(_U["Fe"]) + _b20_basis(_U["Ge"]),
                        dtype=torch.float64, device=device) % 1.0
    grid = torch.stack(torch.meshgrid(
        *(torch.arange(c, dtype=torch.float64, device=device)
          for c in cells), indexing="ij"), dim=-1).reshape(-1, 1, 3)
    a = float(lattice["a_A"])
    pos = ((grid + frac[None]) * a).reshape(-1, 3).to(torch.float32)
    types = torch.tensor([0] * 4 + [1] * 4, dtype=torch.int32,
                         device=device).repeat(grid.shape[0])
    box = torch.tensor([c * a for c in cells], dtype=torch.float32,
                       device=device)
    return pos, types, box


def ferro(types, moments):
    m = (moments[types.long()] > 0).to(torch.float32)
    s = torch.zeros((types.shape[0], 3), dtype=torch.float32,
                    device=types.device)
    s[:, 2] = m
    return s


def state(config: dict, traffic: dict, cells, seed: int, device) -> dict:
    """The starting state: B20 at ``cells`` unit cells a side, spins along
    +z, velocities at the mix's temperature (zero net momentum)."""
    pos, types, box = crystal(config["lattice"], cells, device)
    moments = torch.tensor(config["lattice"]["moments_muB"], device=device)
    masses = torch.tensor(config["lattice"]["masses_gmol"],
                          dtype=torch.float32, device=device)
    temp = float(traffic["temperature_K"])
    g = generator(seed, 2, device)
    sigma = torch.sqrt(KB * HEAT_FACTOR * temp
                       / (masses[types.long()] * MVV2E))
    v = sigma[:, None] * torch.randn(pos.shape, generator=g, device=device)
    return {"pos": pos, "vel": v - v.mean(dim=0, keepdim=True),
            "spin": ferro(types, moments), "types": types, "box": box,
            "masses": masses, "moments": moments, "temperature": temp}


def noise_generator(seed: int, rank: int, device) -> torch.Generator:
    """The generator of rank ``rank``'s thermostat noise (the program draws
    the noise from it; the reference replays its draws)."""
    return generator(seed, 16 + rank, device)
