"""Spin-lattice dynamical state (port of ``repro.md.state``)."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.md.lattice import Lattice
from repro_torch.utils import units
from repro_torch.utils.device import resolve_device


class SpinLatticeState(NamedTuple):
    """Coupled (R, S) state. One spin per atom (zero for nonmagnetic types).

    ``step`` is a host integer: the step counter never has to be read back
    from the device.
    """

    pos: torch.Tensor     # (N, 3) [A]
    vel: torch.Tensor     # (N, 3) [A/ps]
    spin: torch.Tensor    # (N, 3) spin direction * magnitude
    types: torch.Tensor   # (N,) int32
    box: torch.Tensor     # (3,) [A]
    step: int = 0


def state_from_numpy(pos, vel, spin, types, box, step: int = 0, *,
                     dtype=torch.float32, device="cuda") -> SpinLatticeState:
    """State from host arrays, so a test can start the port and the JAX
    package from the same numbers."""
    dev = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return SpinLatticeState(
        pos=f(pos), vel=f(vel), spin=f(spin),
        types=torch.as_tensor(np.asarray(types), dtype=torch.int32,
                              device=dev),
        box=f(box), step=int(step))


def init_state(
    lattice: Lattice,
    n_cells: tuple[int, int, int],
    *,
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    spin_init: str = "helix_x",
    helix_pitch: float | None = None,
    dtype=torch.float32,
    device="cuda",
) -> SpinLatticeState:
    """Build a supercell state with thermalized velocities and a spin texture.

    spin_init: 'helix_x' (helical modulation along x), 'ferro_z', 'random'.
    Random draws come from ``generator`` (a fresh one seeded 0 if omitted);
    it must live on ``device``.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pos_np, types_np, box_np = lattice.supercell(*n_cells)
    n = pos_np.shape[0]
    pos = torch.as_tensor(pos_np, dtype=dtype, device=dev)
    types = torch.as_tensor(types_np, dtype=torch.int32, device=dev)
    box = torch.as_tensor(box_np, dtype=dtype, device=dev)
    masses = torch.as_tensor(lattice.masses, dtype=dtype, device=dev)[types]

    if temperature > 0:
        sigma = torch.sqrt(units.KB * temperature / (masses * units.MVV2E))
        vel = sigma[:, None] * torch.randn((n, 3), generator=generator,
                                           dtype=dtype, device=dev)
        vel = vel - vel.mean(dim=0, keepdim=True)   # zero net momentum
    else:
        vel = torch.zeros((n, 3), dtype=dtype, device=dev)

    mag_by_type = torch.as_tensor(lattice.moments, device=dev)[types] > 0
    if spin_init == "ferro_z":
        s = torch.zeros((n, 3), dtype=dtype, device=dev)
        s[:, 2] = 1.0
    elif spin_init == "random":
        v = torch.randn((n, 3), generator=generator, dtype=dtype, device=dev)
        s = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    elif spin_init == "helix_x":
        pitch = helix_pitch if helix_pitch is not None else float(box_np[0])
        phase = (2.0 * math.pi / pitch) * pos[:, 0]
        # Bloch-type helix propagating along x (spins rotate in the y-z
        # plane), the chirality selected by bulk DMI in B20 FeGe
        s = torch.stack([torch.zeros_like(phase), torch.cos(phase),
                         torch.sin(phase)], dim=-1)
    else:
        raise ValueError(f"unknown spin_init {spin_init!r}")
    spin = torch.where(mag_by_type[:, None], s, torch.zeros_like(s))
    return SpinLatticeState(pos=pos, vel=vel, spin=spin, types=types,
                            box=box, step=0)


def kinetic_energy(state: SpinLatticeState,
                   masses: torch.Tensor) -> torch.Tensor:
    m = masses[state.types.long()]
    return 0.5 * units.MVV2E * torch.sum(m[:, None] * state.vel ** 2)


def temperature_of(state: SpinLatticeState,
                   masses: torch.Tensor) -> torch.Tensor:
    """Lattice temperature [K] from the kinetic energy (3N degrees)."""
    n = state.pos.shape[0]
    return 2.0 * kinetic_energy(state, masses) / (3.0 * n * units.KB)
