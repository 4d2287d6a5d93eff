"""One coupled spin-lattice step, the splitting of arXiv:2606.14073:

    O(dt/2) B(dt/2) S(dt/2) A(dt) [evaluate] S(dt/2) B(dt/2) O(dt/2)

O is the exact Ornstein-Uhlenbeck half-step of the Langevin lattice
thermostat, B the velocity kick, A the drift (wrapped into the box), S an
exact Rodrigues rotation of each magnetic spin about its stochastic-LLG
angular velocity, with the transverse thermal field drawn for the half-step
it acts over.  The five standard-normal draws of a step (k1, k2, k3, k5 in
that order) are given, one row per atom.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference.units import FORCE2ACC, GYRO, KB, MU_B, MVV2E


def _rotate(s, h, noise, temp: float, cfg: dict):
    half = 0.5 * cfg["dt_ps"]
    alpha, moment = cfg["spin_alpha"], cfg["moment_muB"]
    b = h / (moment * MU_B)
    sigma = math.sqrt(2.0 * alpha * KB * temp / (GYRO * moment * MU_B * half))
    b = b + sigma * noise
    gp = GYRO / (1.0 + alpha ** 2)
    omega = gp * b + gp * alpha * torch.linalg.cross(s, b, dim=-1)
    theta = torch.linalg.norm(omega, dim=-1, keepdim=True)
    axis = omega / torch.where(theta > 0, theta, torch.ones_like(theta))
    ang = theta * half
    c, sn = torch.cos(ang), torch.sin(ang)
    return (s * c + torch.linalg.cross(axis, s, dim=-1) * sn
            + axis * torch.sum(axis * s, dim=-1, keepdim=True) * (1.0 - c))


def _ou(vel, m, noise, temp: float, cfg: dict):
    c1 = math.exp(-cfg["lattice_gamma_per_ps"] * 0.5 * cfg["dt_ps"])
    sigma = torch.sqrt(KB * temp * (1.0 - c1 ** 2) / (m * MVV2E))
    return c1 * vel + sigma * noise


def step(pos, vel, spin, box, m, magnetic, force, heff, noise: dict,
         temp: float, cfg: dict, evaluate):
    """``(pos, vel, spin, (E, F, H))`` one step on; ``force``/``heff`` are
    the evaluation the step starts from, ``evaluate(pos, spin)`` makes the
    one at the drifted positions and half-turned spins, which the step
    returns (and the next starts from)."""
    dt = cfg["dt_ps"]
    mag = magnetic[:, None]
    vel = _ou(vel, m, noise["k1"], temp, cfg)
    vel = vel + 0.5 * dt * force / m * FORCE2ACC
    spin = torch.where(mag, _rotate(spin, heff, noise["k2"], temp, cfg), spin)
    pos = pos + dt * vel
    pos = pos - box * torch.floor(pos / box)
    ff = evaluate(pos, spin)
    spin = torch.where(mag, _rotate(spin, ff[2], noise["k3"], temp, cfg),
                       spin)
    vel = vel + 0.5 * dt * ff[1] / m * FORCE2ACC
    vel = _ou(vel, m, noise["k5"], temp, cfg)
    return pos, vel, spin, ff
