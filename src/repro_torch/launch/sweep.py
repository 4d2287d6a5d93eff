#!/usr/bin/env python3
"""(T, B) phase-diagram sweep (port of ``repro.launch.sweep``).

    PYTHONPATH=src python3 -m repro_torch.launch.sweep [--preset smoke|full]
        [--replicas R] [--steps N] [--temps 40,95] [--fields 0,25]
        [--seed S] [--device cuda|cpu]

Fans replicas over the (T, B) grid through the replica engine
(:mod:`repro_torch.ensemble.sweep`) on the reduced-scale strong-DMI film and
prints the filled PhaseDiagram: |Q| (skyrmion count scale), <S_z> and the
helix pitch per grid cell - the helix -> skyrmion phase map of the paper's
Figs. 4/9.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_film(ecfg, seed: int = 0, device="cuda", dtype=torch.float32):
    """Reduced-scale strong-DMI film: a helix ground state that fits the
    box (8-site textures).  Returns ``(lattice, model, state)``."""
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.state import init_state
    lat = simple_cubic()
    d_over_j = float(np.tan(2 * np.pi / 8))
    ham = HeisenbergDMIModel(d0=0.0166 * d_over_j, gamma_j=0.0,
                             gamma_d=0.0, ka=0.0)
    st = init_state(lat, ecfg.n_cells, spin_init="helix_x",
                    helix_pitch=8 * lat.a, generator=torch.Generator(
                        device=device).manual_seed(seed),
                    dtype=dtype, device=device)
    return lat, ham, st


def main() -> int:
    from repro_torch.configs.fege_spinlattice import (
        nucleation_ensemble, nucleation_ensemble_smoke)
    from repro_torch.ensemble.sweep import run_sweep
    from repro_torch.md.integrator import IntegratorConfig
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--replicas", type=int, default=0)
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--temps", default="",
                    help="comma-separated T grid [K] (default: preset)")
    ap.add_argument("--fields", default="",
                    help="comma-separated B grid [T] (default: preset)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    ecfg = (nucleation_ensemble_smoke() if args.preset == "smoke"
            else nucleation_ensemble())
    n_rep = args.replicas or ecfg.n_replicas
    n_steps = args.steps or ecfg.n_steps
    temps = ([float(x) for x in args.temps.split(",")] if args.temps
             else list(ecfg.sweep_temperatures))
    fields = ([float(x) for x in args.fields.split(",")] if args.fields
              else list(ecfg.sweep_fields))

    lat, ham, st = build_film(ecfg, args.seed, args.device)
    dev = st.pos.device
    cfg = IntegratorConfig(dt=ecfg.dt, lattice_gamma=ecfg.lattice_gamma,
                           spin_alpha=ecfg.spin_alpha)
    n_atoms = st.pos.shape[0]
    n_tot = len(temps) * len(fields) * n_rep
    print(f"sweep: {len(temps)}x{len(fields)} grid x {n_rep} replicas = "
          f"{n_tot} batched replicas, {n_atoms} atoms each, {n_steps} steps "
          f"on {dev}")
    t0 = time.perf_counter()
    pd = run_sweep(
        st, ham, cfg, torch.tensor(lat.masses, dtype=st.pos.dtype,
                                   device=dev),
        torch.tensor(lat.moments, device=dev) > 0, temps, fields,
        n_replicas=n_rep, n_steps=n_steps, seed=args.seed, cutoff=5.0,
        capacity=8, chunk=ecfg.chunk, device=dev)
    wall = time.perf_counter() - t0
    print(f"\n{pd.summary()}")
    print(f"\n<S_z>:\n{np.array2string(pd.magnetization, precision=3)}")
    print(f"pitch [A]:\n{np.array2string(pd.pitch, precision=1)}")
    print(f"\n{wall:.1f}s wall, {n_tot * n_atoms * n_steps / wall:.3e} "
          "atom-step/s aggregate")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
