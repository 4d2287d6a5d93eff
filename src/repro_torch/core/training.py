"""NEP-SPIN training: fit the potential to synthetic constrained-DFT data
(port of ``repro.core.training``).

Pipeline (paper Sec. 3, with the DFT oracle replaced by the reference
spin-lattice Hamiltonian):

  1. sample magnetic excited configurations: thermal lattice displacements
     and non-collinear spins (random cone tilts, longitudinal fluctuations)
     around B20 FeGe;
  2. label them with energy / forces / magnetic torques from the oracle
     (:class:`~repro_torch.core.hamiltonian.HeisenbergDMIModel`);
  3. fit NEP-SPIN by SNES (the paper's neuroevolution route) or Adam (the
     gradient route);
  4. report RMSEs (paper Table IV).

The loss's force and field terms are derivatives of E, so the evaluation
(``energy_forces_field`` on the batch of configurations: they share one
atom count and type list) keeps its graph (``create_graph=True``) and Adam
differentiates through it.  No kernel is involved: K1 and K2 have no
backward, and training differentiates the autograd evaluation.

Random draws come from a ``torch.Generator`` where the reference takes a
key; :func:`generate_dataset` and :func:`fit_snes` also take the caller's
draws, so a test can feed them the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.descriptor import NEPSpinSpec, descriptors
from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.core.potential import (NEPSpinParams, energy_forces_field,
                                        init_params)
from repro_torch.md.lattice import Lattice
from repro_torch.md.neighbor import (NeighborTable, dense_neighbor_table,
                                     gather_neighbors)
from repro_torch.md.state import init_state
from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         snes_ask, snes_init, snes_member,
                                         snes_tell)
from repro_torch.utils.device import resolve_device


class Dataset(NamedTuple):
    """Batched configurations with oracle labels (fixed n_atoms)."""

    pos: torch.Tensor      # (C, N, 3)
    spin: torch.Tensor     # (C, N, 3)
    types: torch.Tensor    # (N,)
    box: torch.Tensor      # (3,)
    e_ref: torch.Tensor    # (C,)
    f_ref: torch.Tensor    # (C, N, 3)
    h_ref: torch.Tensor    # (C, N, 3)


def sample_draws(n_configs: int, n_atoms: int, generator: torch.Generator,
                 *, dtype=torch.float32, device="cuda") -> dict:
    """The standard variates :func:`generate_dataset` turns into
    configurations: ``disp`` and ``axis`` (C, N, 3) normal, ``cone``
    (C, N, 1) uniform on [0, 1), ``fluct`` (C, N, 1) normal."""
    dev = resolve_device(device)
    kw = dict(generator=generator, dtype=dtype, device=dev)
    return {"disp": torch.randn((n_configs, n_atoms, 3), **kw),
            "axis": torch.randn((n_configs, n_atoms, 3), **kw),
            "cone": torch.rand((n_configs, n_atoms, 1), **kw),
            "fluct": torch.randn((n_configs, n_atoms, 1), **kw)}


def generate_dataset(
    oracle: HeisenbergDMIModel,
    lattice: Lattice,
    n_cells: tuple[int, int, int],
    n_configs: int,
    generator: torch.Generator | None = None,
    *,
    disp: float = 0.08,            # A, thermal displacement scale
    spin_cone: float = 0.6,        # rad, spin tilt scale
    mag_fluct: float = 0.1,        # longitudinal |S| fluctuation
    capacity: int = 64,
    draws: dict | None = None,
    dtype=torch.float32,
    device="cuda",
) -> Dataset:
    """Sample and label magnetic excited configurations.

    ``draws`` (as :func:`sample_draws` returns them) replaces the draws
    from ``generator``."""
    dev = resolve_device(device)
    base = init_state(lattice, n_cells, spin_init="ferro_z", dtype=dtype,
                      device=dev)
    n = base.pos.shape[0]
    mag = torch.as_tensor(lattice.moments, device=dev)[base.types.long()] > 0
    if draws is None:
        draws = sample_draws(n_configs, n, generator, dtype=dtype, device=dev)
    d = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in draws.items()}
    pos = base.pos + disp * d["disp"]
    # random non-collinear spins: cone tilt around a random axis
    v = d["axis"] / torch.linalg.norm(d["axis"], dim=-1, keepdim=True)
    alpha = spin_cone * d["cone"]
    z = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    s = torch.cos(alpha) * z + torch.sin(alpha) * v
    s = s / torch.linalg.norm(s, dim=-1, keepdim=True)
    s = s * (1.0 + mag_fluct * d["fluct"])
    spin = torch.where(mag[:, None], s, torch.zeros_like(s))

    labels = []
    for c in range(pos.shape[0]):
        table = dense_neighbor_table(pos[c], base.box, oracle.cutoff,
                                     capacity)
        labels.append(oracle.energy_forces_field(pos[c], spin[c], base.types,
                                                 table, base.box))
    e, f, h = (torch.stack(x) for x in zip(*labels))
    return Dataset(pos=pos, spin=spin, types=base.types, box=base.box,
                   e_ref=e, f_ref=f, h_ref=h)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def dataset_tables(ds: Dataset, cutoff: float,
                   capacity: int = 64) -> NeighborTable:
    """Every configuration's dense neighbor table, stacked into one (C, N,
    M) table.  Positions are fixed, so a fit builds it once."""
    tabs = [dense_neighbor_table(p, ds.box, cutoff, capacity)
            for p in ds.pos]
    return NeighborTable(*(torch.stack([getattr(t, k) for t in tabs])
                           for k in ("idx", "mask", "r0")),
                         cutoff=tabs[0].cutoff)


def _predict(spec: NEPSpinSpec, params: NEPSpinParams, ds: Dataset,
             capacity: int = 64, *, tables=None, create_graph: bool = False):
    """Every configuration's (E (C,), F (C, N, 3), H_eff (C, N, 3)) by
    autograd through the gather (:func:`~repro_torch.core.potential.
    energy_forces_field` on the batch of configurations, the reference's
    ``lax.map`` in one evaluation); ``create_graph`` keeps the graph into
    ``params``."""
    tables = tables if tables is not None else dataset_tables(
        ds, spec.cutoff, capacity)
    return energy_forces_field(spec, params, ds.pos, ds.spin, ds.types,
                               tables, ds.box, create_graph=create_graph)


def rmse_metrics(spec, params, ds: Dataset, *, tables=None) -> dict:
    """E (per atom), F and H RMSEs against the labels, as floats."""
    with torch.no_grad():
        e, f, h = _predict(spec, params, ds, tables=tables)
    n = ds.pos.shape[1]
    return {
        "e_rmse_per_atom": float(torch.sqrt(torch.mean(
            (e - ds.e_ref) ** 2))) / n,
        "f_rmse": float(torch.sqrt(torch.mean((f - ds.f_ref) ** 2))),
        "h_rmse": float(torch.sqrt(torch.mean((h - ds.h_ref) ** 2))),
    }


def loss_fn(spec, params, ds: Dataset, we=1.0, wf=1.0, wh=1.0, *,
            tables=None, create_graph: bool = True) -> torch.Tensor:
    """Weighted mean-square error of E per atom, F and H (a 0-d tensor,
    differentiable in ``params`` unless ``create_graph=False``)."""
    e, f, h = _predict(spec, params, ds, tables=tables,
                       create_graph=create_graph)
    n = ds.pos.shape[1]
    le = torch.mean(torch.square((e - ds.e_ref) / n))
    lf = torch.mean(torch.square(f - ds.f_ref))
    lh = torch.mean(torch.square(h - ds.h_ref))
    return we * le + wf * lf + wh * lh


def loss_and_grad(spec, params: NEPSpinParams, ds: Dataset, *, tables=None):
    """(loss, gradients in ``NEPSpinParams`` order): the reference's
    ``jax.value_and_grad`` of :func:`loss_fn` over every leaf."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        loss = loss_fn(spec, NEPSpinParams(*leaves), ds, tables=tables)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not read (c_spin of a spin-free spec) has a
    # zero gradient, as jax.grad gives it
    return loss.detach(), NEPSpinParams(*(
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)))


# ---------------------------------------------------------------------------
# descriptor normalization (NEP convention: scale to unit range on the
# training set)
# ---------------------------------------------------------------------------

def calibrate_scale(spec, params, ds: Dataset, capacity: int = 64, *,
                    tables=None):
    """``params`` with ``q_scale`` the largest |q| of each descriptor over
    the first 8 configurations (at least 1e-3)."""
    tables = tables if tables is not None else dataset_tables(
        ds, spec.cutoff, capacity)
    first = NeighborTable(tables.idx[:8], tables.mask[:8], tables.r0[:8],
                          tables.cutoff)
    with torch.no_grad():
        dr, dist, sj, tj, mask = gather_neighbors(
            ds.pos[:8], ds.spin[:8], ds.types, first, ds.box)
        q = descriptors(spec, params.desc_params(), dr, dist, mask,
                        ds.types, tj, ds.spin[:8], sj)
        scale = torch.clamp(torch.amax(torch.abs(q), dim=(0, 1)), min=1e-3)
    return params._replace(q_scale=scale)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def _init(spec, ds, generator, params):
    if params is not None:
        return params
    return init_params(spec, generator, dtype=ds.pos.dtype,
                       device=ds.pos.device)


def fit_adam(spec, ds: Dataset, generator: torch.Generator | None = None,
             steps: int = 200, lr: float = 1e-2,
             params: NEPSpinParams | None = None, verbose: bool = False):
    """Adam (no weight decay, global-norm clip 10) on :func:`loss_fn` from
    ``params`` (default: drawn from ``generator``), after
    :func:`calibrate_scale`; returns (params, the loss before each step)."""
    tables = dataset_tables(ds, spec.cutoff)
    params = calibrate_scale(spec, _init(spec, ds, generator, params), ds,
                             tables=tables)
    opt = adamw_init(params)
    hist = []
    for i in range(steps):
        loss, grads = loss_and_grad(spec, params, ds, tables=tables)
        params, opt = adamw_update(params, grads, opt, lr, weight_decay=0.0,
                                   grad_clip=10.0)
        hist.append(float(loss))
        if verbose and i % 20 == 0:
            print(f"  adam step {i}: loss {hist[-1]:.6f}")
    return params, hist


def fit_snes(spec, ds: Dataset, generator: torch.Generator | None = None,
             generations: int = 100, popsize: int = 32, sigma0: float = 0.05,
             params: NEPSpinParams | None = None, verbose: bool = False,
             noise=None):
    """Separable NES (NEP = neuroevolution potential): derivative-free,
    slower than Adam.  ``noise`` (one list of half draws per generation,
    as :func:`~repro_torch.train.optimizer.snes_ask` takes them) replaces
    the draws from ``generator``.  Returns (mean params, the best fitness
    of each generation).

    The population is evaluated one member at a time, in a Python loop:
    each member is a whole batched evaluation of the dataset, and the
    reference's ``jax.vmap`` over members has no counterpart here."""
    tables = dataset_tables(ds, spec.cutoff)
    params = calibrate_scale(spec, _init(spec, ds, generator, params), ds,
                             tables=tables)
    state = snes_init(params, sigma0)
    hist = []
    for g in range(generations):
        pop, z = snes_ask(state, generator, popsize,
                          noise=None if noise is None else noise[g])
        fit = torch.stack([
            loss_fn(spec, snes_member(pop, i, params), ds, tables=tables,
                    create_graph=False)
            for i in range(pop[0].shape[0])])
        state = snes_tell(state, z, fit)
        hist.append(float(torch.min(fit)))
        if verbose and g % 10 == 0:
            print(f"  snes gen {g}: best {hist[-1]:.6f}")
    return state.mean, hist
