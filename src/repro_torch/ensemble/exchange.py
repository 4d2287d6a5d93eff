"""Parallel-tempering replica exchange (port of ``repro.ensemble.exchange``).

Replicas run at a fixed temperature ladder; periodically, neighboring
temperature slots attempt to swap *configurations* with the standard
acceptance

    A(i <-> j) = min(1, exp[(beta_i - beta_j)(E_i - E_j)])

which satisfies detailed balance with respect to the product distribution
prod_k exp(-beta_k E(x_k)).  Swaps alternate even/odd neighbor pairs.  On
acceptance the velocities of the swapped configurations are rescaled by
sqrt(T_new/T_old) so the lattice kinetic energy re-thermalizes at once at the
new slot temperature.

The criterion is evaluated on the host in float64 (an exchange reads the
energies back once); its uniforms come from a ``torch.Generator`` or, so a
test can feed in the reference's draws, from the caller (``u=``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.md.integrator import ForceField
from repro_torch.md.state import SpinLatticeState
from repro_torch.utils import units


def _host(x) -> torch.Tensor:
    """``x`` (a tensor, array or Python number) as a CPU float64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64)
    return torch.as_tensor(np.asarray(x, np.float64))


def swap_probability(beta_i, beta_j, e_i, e_j) -> torch.Tensor:
    """Metropolis acceptance for swapping configs between slots i and j."""
    bi, bj, ei, ej = (_host(x) for x in (beta_i, beta_j, e_i, e_j))
    return torch.clamp(torch.exp((bi - bj) * (ei - ej)), max=1.0)


def swap_permutation(energies, temperatures, parity: int, *,
                     generator: torch.Generator | None = None, u=None):
    """One even/odd sweep of neighbor swap attempts.

    Returns ``(perm, accepted)`` on the host: ``perm[s]`` is the slot whose
    configuration moves INTO slot ``s`` (identity where rejected), and
    ``accepted`` the accept mask of the ``floor((R - parity) / 2)`` pairs
    tried, each accepted when its uniform - ``u[k]``, or a draw from the
    CPU ``generator`` - is below its acceptance.
    """
    e, t = _host(energies), _host(temperatures)
    r = e.shape[0]
    lo = torch.arange(parity, r - 1, 2)
    if lo.numel() == 0:
        return torch.arange(r), torch.zeros((0,), dtype=torch.bool)
    hi = lo + 1
    beta = 1.0 / (units.KB * t)
    p = swap_probability(beta[lo], beta[hi], e[lo], e[hi])
    if u is None:
        if generator is None:
            raise ValueError("swap_permutation needs a generator or u=")
        u = torch.rand(p.shape, generator=generator, dtype=torch.float64)
    acc = _host(u).reshape(p.shape) < p
    perm = torch.arange(r)
    perm[lo] = torch.where(acc, hi, lo)
    perm[hi] = torch.where(acc, lo, hi)
    return perm, acc


def apply_exchange(states: SpinLatticeState, ffs: ForceField, temperatures,
                   parity: int, *, generator: torch.Generator | None = None,
                   u=None):
    """Attempt one sweep of neighbor swaps and permute the replica batch.

    ``states`` / ``ffs`` are replica batches (leading axis R);
    ``ffs.energy`` (R,) is the potential energy of the criterion.  Returns
    ``(states, ffs, n_accepted, n_attempted)``.
    """
    perm, acc = swap_permutation(ffs.energy, temperatures, parity,
                                 generator=generator, u=u)
    ix = perm.to(states.pos.device)
    t = _host(temperatures)
    # the configuration from slot perm[s] (T = temperatures[perm]) now sits
    # in slot s (T = temperatures[s]): rescale its velocities to the bath
    scale = torch.sqrt(t / t[perm]).to(states.vel.device, states.vel.dtype)
    states = SpinLatticeState(
        pos=states.pos[ix], vel=states.vel[ix] * scale[:, None, None],
        spin=states.spin[ix], types=states.types[ix], box=states.box[ix],
        step=np.asarray(states.step)[perm.numpy()])
    ffs = ForceField(*(x[ix] for x in ffs))
    return states, ffs, int(acc.sum()), int(acc.numel())
