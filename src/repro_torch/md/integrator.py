"""Structure-preserving coupled spin-lattice integrator (port of
``repro.md.integrator``).

Suzuki-Trotter splitting

    v(dt/2) -> S(dt/2) -> x(dt) -> recompute (F, H) -> S(dt/2) -> v(dt/2)

with exact Rodrigues spin rotations about the local effective field, the
optional self-consistent midpoint iteration for the spin half-steps, a
Langevin (OBABO) lattice thermostat, stochastic LLG transverse spin noise
and an optional longitudinal Landau channel for |S|.

``make_fused_step`` is the gather-once step of the Engine; ``make_step``
is the un-split legacy surface (one whole evaluation per force call).

Randomness: the step's five noise streams (k1 lattice kick before, k2/k3 the
two spin half-steps, k4 longitudinal, k5 lattice kick after - the reference
splits its step key the same way) are drawn from an explicit
``torch.Generator``, or taken from a ``noise={"k1": ..., ...}`` dict of
pre-drawn standard normals so a test can feed in the reference's draws.

Replica batches (the Replicated plan): the same step takes state tensors
with a leading replica axis R, one ``torch.Generator`` per replica (replica
r draws its noise from its own generator in the flat step's order), one
temperature per replica and fields (R, 3).  The noise scales are computed
per replica on the host exactly as the flat step computes its one scale, so
each replica's arithmetic is the flat step's on its own inputs.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.md.state import SpinLatticeState
from repro_torch.telemetry.profiling import host_sync
from repro_torch.utils import units


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    dt: float = 1.0e-3            # ps
    moment: float = 1.16          # mu_B per magnetic atom
    # self-consistent midpoint spin update
    midpoint: bool = False
    midpoint_iters: int = 3
    midpoint_mixing: float = 1.0  # <1 = regularized fixed point
    # thermostats (0 = off -> NVE, structure-preserving)
    temperature: float = 0.0      # K (default; runtime arg overrides)
    lattice_gamma: float = 0.0    # 1/ps Langevin friction
    spin_alpha: float = 0.0       # Gilbert damping
    spin_longitudinal: float = 0.0  # 1/ps longitudinal relaxation rate
    frozen_lattice: bool = False  # positions/velocities not advanced


class ForceField(NamedTuple):
    """Output of one potential evaluation (a replica batch adds a leading
    R to each field)."""
    energy: torch.Tensor  # ()
    force: torch.Tensor   # (N,3) eV/A
    field: torch.Tensor   # (N,3) -dE/dS, eV


NOISE_KEYS = ("k1", "k2", "k3", "k4", "k5")


def _scale(temp, fn, like: torch.Tensor, ndim: int):
    """A noise scale ``fn(T)``: a Python float for one temperature, or for
    a replica batch's temperatures (a list) an (R, 1, ...) tensor with
    ``ndim`` trailing ones, each entry ``fn(T_r)`` computed in Python as the
    flat step computes its scale and rounded to ``like``'s dtype as a Python
    scalar operand would be."""
    if not isinstance(temp, list):
        return fn(temp)
    with host_sync():    # a blocking copy to the card
        scale = torch.tensor([fn(t) for t in temp], dtype=like.dtype,
                             device=like.device)
    return scale.reshape((-1,) + (1,) * ndim)


def _rodrigues(s: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """Rotate spins s about axis/angle omega*dt (exact, norm-conserving)."""
    theta = torch.linalg.norm(omega, dim=-1, keepdim=True)
    axis = omega / torch.where(theta > 0, theta, torch.ones_like(theta))
    ang = theta * dt
    c, sn = torch.cos(ang), torch.sin(ang)
    return (s * c + torch.linalg.cross(axis, s, dim=-1) * sn
            + axis * torch.sum(axis * s, dim=-1, keepdim=True) * (1.0 - c))


def _precession_rate(field: torch.Tensor, spin: torch.Tensor,
                     cfg: IntegratorConfig, noise: torch.Tensor | None,
                     temp: float, duration: float | None = None):
    """Angular velocity omega (N,3) [rad/ps] incl. damping + thermal noise:
    omega = g' (B + b_th) + g' alpha (S x B), g' = gyro/(1+alpha^2),
    <b_th^2> = 2 alpha kB T / (gyro mu tau) for the kick duration tau."""
    b = field / (cfg.moment * units.MU_B)       # Tesla
    tau = duration if duration is not None else cfg.dt
    if cfg.spin_alpha > 0.0 and noise is not None:
        sigma = _scale(temp, lambda t: math.sqrt(
            2.0 * cfg.spin_alpha * units.KB * t
            / (units.GYRO * cfg.moment * units.MU_B * tau)), noise,
            noise.dim() - 1)
        b = b + sigma * noise
    gp = units.GYRO / (1.0 + cfg.spin_alpha ** 2)
    omega = gp * b
    if cfg.spin_alpha > 0.0:
        omega = omega + gp * cfg.spin_alpha * torch.linalg.cross(spin, b,
                                                                 dim=-1)
    return omega


def _spin_half_step(field_eval: Callable[[torch.Tensor], ForceField],
                    spin: torch.Tensor, ff: ForceField, cfg: IntegratorConfig,
                    noise: torch.Tensor | None, temp: float):
    """Advance spins by dt/2; optionally the self-consistent midpoint
    iteration (``field_eval(spin)`` re-evaluates at the current positions;
    every iteration reuses the same noise draw)."""
    half = 0.5 * cfg.dt

    def rotate(field, s0):
        omega = _precession_rate(field, s0, cfg, noise, temp, duration=half)
        return _rodrigues(s0, omega, half)

    s_new = rotate(ff.field, spin)
    if not cfg.midpoint:
        return s_new, ff
    nrm = torch.linalg.norm(spin, dim=-1, keepdim=True)
    for _ in range(cfg.midpoint_iters):
        mid = 0.5 * (spin + s_new)
        mid = mid / torch.clamp(torch.linalg.norm(mid, dim=-1, keepdim=True),
                                min=1e-30) * nrm
        ff = field_eval(mid)
        s_next = rotate(ff.field, spin)
        if cfg.midpoint_mixing < 1.0:
            s_next = (cfg.midpoint_mixing * s_next
                      + (1.0 - cfg.midpoint_mixing) * s_new)
        s_new = s_next
    return s_new, ff


def _longitudinal_step(spin: torch.Tensor, ff: ForceField,
                       cfg: IntegratorConfig, noise: torch.Tensor | None,
                       temp: float, mag_mask: torch.Tensor) -> torch.Tensor:
    """Overdamped Langevin dynamics of |S| along s_hat (Landau channel)."""
    if cfg.spin_longitudinal <= 0.0:
        return spin
    nrm = torch.linalg.norm(spin, dim=-1, keepdim=True)
    shat = spin / torch.clamp(nrm, min=1e-30)
    f_long = torch.sum(ff.field * shat, dim=-1, keepdim=True)
    eta = cfg.spin_longitudinal
    dnrm = eta * cfg.dt * f_long
    if noise is not None:
        dnrm = dnrm + _scale(temp, lambda t: math.sqrt(
            2.0 * eta * units.KB * t * cfg.dt), noise, noise.dim() - 1) * noise
    new_nrm = torch.clamp(nrm + dnrm, min=1e-3)
    return torch.where(mag_mask[..., None], shat * new_nrm, spin)


def _lattice_langevin(vel: torch.Tensor, masses: torch.Tensor,
                      cfg: IntegratorConfig, noise: torch.Tensor,
                      temp: float) -> torch.Tensor:
    """Exact half-step Ornstein-Uhlenbeck velocity update (OBABO)."""
    c1 = math.exp(-cfg.lattice_gamma * 0.5 * cfg.dt)
    kt = _scale(temp, lambda t: units.KB * t * (1.0 - c1 ** 2), vel,
                vel.dim() - 2)
    # (a Python scalar over a tensor is the tensor's reciprocal times it)
    sigma = torch.sqrt(torch.reciprocal(masses * units.MVV2E) * kt)
    return c1 * vel + sigma[..., None] * noise


def _masked(occ, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` on occupied slots, ``old`` on empty ones (no mask: new)."""
    return new if occ is None else torch.where(occ[..., None], new, old)


def make_fused_step(gather: Callable, compute: Callable, cfg: IntegratorConfig,
                    masses: torch.Tensor, magnetic: torch.Tensor,
                    atom_mask: str | None = None,
                    spin_aware_gather: bool = False):
    """Build the gather-once coupled step

        step(state, ff, nbh, generator=None, temperature=None, field=None,
             noise=None) -> (state, ff, nbh)

    ``gather(pos, nbh) -> nbh`` refreshes the neighbor blocks once after the
    drift; ``compute(nbh, spin, types, field) -> ForceField`` evaluates the
    potential.  ``temperature`` (K) and ``field`` ((3,) Tesla) override the
    config at run time; any ``temperature`` (or ``cfg.temperature > 0``)
    turns the thermostats on, and their normal draws then come from
    ``noise[k]`` where given, else from ``generator``.

    A replica batch (``state.pos`` (R, N, 3)) takes a sequence of R
    generators, ``temperature`` None or a sequence of R values and
    ``field`` (R, 3) (module docstring); so does the Sharded plan's batch
    of local replicas, (R, cx, cy, cz, K, ...) blocks.

    Cell-blocked domain tensors (the Sharded plan: ``(cx, cy, cz, K, ...)``)
    go through the same elementwise updates: ``atom_mask="from_types"``
    freezes the empty slots (``types == -1``; their velocities, spins and
    noise stay out), and with ``spin_aware_gather`` the refresh after the
    drift is called as ``gather(pos, nbh, spin)`` with the half-stepped
    spins, so the neighbor spins ride the positions' halo exchange.
    """
    def step(state: SpinLatticeState, ff: ForceField, nbh,
             generator: torch.Generator | None = None, temperature=None,
             field=None, noise: dict | None = None):
        # a replica axis: (R, N, 3), or (R, cx, cy, cz, K, 3) cell blocks
        batch = state.pos.dim() in (3, 6)
        types = torch.clamp(state.types.long(), min=0)
        m = masses[types][..., None]
        mag = magnetic[types]
        occ = state.types >= 0 if atom_mask == "from_types" else None
        if occ is not None:
            mag = mag & occ
        dt = cfg.dt
        stochastic = (temperature is not None) or cfg.temperature > 0.0
        if batch:     # one temperature per replica: _scale takes the list
            temp = ([cfg.temperature] * state.pos.shape[0]
                    if temperature is None
                    else [max(float(t), 0.0) for t in temperature])
        else:
            temp = (cfg.temperature if temperature is None
                    else max(float(temperature), 0.0))
        noise = noise or {}

        def draw(key, shape):
            if not stochastic:
                return None
            if key in noise:
                return noise[key]
            if generator is None:
                raise ValueError("a stochastic step needs a torch.Generator "
                                 f"or pre-drawn noise[{key!r}]")
            kw = dict(dtype=state.pos.dtype, device=state.pos.device)
            if batch:     # replica r's draw from its own generator
                return torch.stack([torch.randn(shape, generator=g, **kw)
                                    for g in generator])
            return torch.randn(shape, generator=generator, **kw)

        def field_eval(nb):
            return lambda s: compute(nb, s, state.types, field)

        shape = tuple(state.pos.shape[1:] if batch else state.pos.shape)
        thermo_lattice = cfg.lattice_gamma > 0.0 and stochastic
        vel = state.vel
        if not cfg.frozen_lattice:
            if thermo_lattice:
                vel = _masked(occ, _lattice_langevin(
                    vel, m[..., 0], cfg, draw("k1", shape), temp), vel)
            vel = vel + 0.5 * dt * ff.force / m * units.FORCE2ACC
        spin_noise = cfg.spin_alpha > 0.0
        spin, ff = _spin_half_step(
            field_eval(nbh), state.spin, ff, cfg,
            draw("k2", shape) if spin_noise else None, temp)
        spin = torch.where(mag[..., None], spin, state.spin)
        if cfg.frozen_lattice:
            pos = state.pos
        else:
            box = state.box[..., None, :]
            pos = state.pos + dt * vel
            pos = pos - box * torch.floor(pos / box)   # wrap PBC
        nbh = (gather(pos, nbh, spin) if spin_aware_gather
               else gather(pos, nbh))
        ff = compute(nbh, spin, state.types, field)
        spin2, ff = _spin_half_step(
            field_eval(nbh), spin, ff, cfg,
            draw("k3", shape) if spin_noise else None, temp)
        spin = torch.where(mag[..., None], spin2, spin)
        spin = _longitudinal_step(
            spin, ff, cfg, draw("k4", shape[:-1] + (1,))
            if cfg.spin_longitudinal > 0.0 else None, temp, mag)
        if not cfg.frozen_lattice:
            vel = vel + 0.5 * dt * ff.force / m * units.FORCE2ACC
            if thermo_lattice:
                vel = _masked(occ, _lattice_langevin(
                    vel, m[..., 0], cfg, draw("k5", shape), temp), vel)
        return SpinLatticeState(pos=pos, vel=vel, spin=spin,
                                types=state.types, box=state.box,
                                step=state.step + 1), ff, nbh

    return step


def _adapt_eval(evaluate: Callable) -> Callable:
    """Accept legacy ``(pos, spin)`` evaluators beside ``(pos, spin,
    field)`` ones: a field-aware evaluator names its third parameter
    ``field`` (an arity check would misroute the field into a closure's
    default parameters)."""
    try:
        pars = list(inspect.signature(evaluate).parameters.values())
    except (TypeError, ValueError):
        return evaluate
    if len(pars) >= 3 and pars[2].name == "field":
        return evaluate

    def ev(pos, spin, field):
        return evaluate(pos, spin)
    return ev


def make_step(evaluate: Callable, cfg: IntegratorConfig, masses: torch.Tensor,
              magnetic: torch.Tensor):
    """The un-split coupled step

        step(state, ff, generator=None, temperature=None, field=None,
             noise=None) -> (state, ff)

    ``evaluate(pos, spin[, field]) -> (E, F, H_eff)`` closes over the types,
    table and box.  It is :func:`make_fused_step` with the positions
    themselves standing in for the gathered blocks."""
    ev = _adapt_eval(evaluate)
    fstep = make_fused_step(
        gather=lambda pos, _nbh: pos,
        compute=lambda pos, spin, types, field: ForceField(
            *ev(pos, spin, field)),
        cfg=cfg, masses=masses, magnetic=magnetic)

    def step(state: SpinLatticeState, ff: ForceField,
             generator: torch.Generator | None = None, temperature=None,
             field=None, noise: dict | None = None):
        state, ff, _ = fstep(state, ff, state.pos, generator, temperature,
                             field, noise)
        return state, ff

    return step
