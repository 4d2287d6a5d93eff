#!/usr/bin/env python3
"""Real-temperature helix -> skyrmion transformation as an ensemble: the
paper's Fig. 9 field-cooling protocol at reduced scale (port of
``examples/skyrmion_nucleation.py``).

    PYTHONPATH=src python3 -m repro_torch.launch.skyrmion_nucleation
        [--steps 2000] [--replicas 8] [--field 25] [--cold]
        [--device cuda|cpu]

A thin FeGe-like film (large D/J so textures fit the box) starts as a helix
and is driven through field cooling: hold hot under a perpendicular field,
ramp the temperature down, hold cold.  All replicas advance together through
the Replicated plan's loop and differ only in their thermostat noise (one
generator each), so the run resolves nucleation *statistics*: with thermal
activation the helix breaks up and nonzero topological charge (skyrmion
seeds) appears in most replicas; without it (``--cold``, deterministic, so
one replica) the helix stays intact under the same field.  The topological
charge Q of every replica is read at every chunk end.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def run(thermal: bool, steps: int, n_replicas: int, field: float,
        seed: int = 0, device="cuda", log=print) -> np.ndarray:
    """One field-cooling ensemble; returns Q per chunk and replica (C, R)."""
    from repro_torch.configs.fege_spinlattice import nucleation_ensemble
    from repro_torch.ensemble import protocol
    from repro_torch.ensemble.replica import spawn_generators
    from repro_torch.launch.sweep import build_film
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.parallel.plan import Replicated
    ecfg = dataclasses.replace(nucleation_ensemble(), n_steps=steps,
                               b_field=field)
    lat, ham, st = build_film(ecfg, seed, device)
    dev = st.pos.device
    cfg = IntegratorConfig(
        dt=ecfg.dt, lattice_gamma=ecfg.lattice_gamma if thermal else 0.0,
        spin_alpha=ecfg.spin_alpha if thermal else 0.0)
    temp, bfield = ecfg.schedules()
    if not thermal:
        temp = protocol.constant(0.0)
    plan = Replicated(n_replicas)
    eng = Engine(
        potential=ham, cfg=cfg, state=st,
        masses=torch.tensor(lat.masses, dtype=st.pos.dtype, device=dev),
        magnetic=torch.tensor(lat.moments, device=dev) > 0, cutoff=5.0,
        capacity=8, plan=plan, temperature=temp, field=bfield,
        diag_grid=(32, 32), observables=("energy", "magnetization", "charge"),
        device=dev)
    label = "thermal" if thermal else "cold"
    log(f"\n=== {label}: T {ecfg.t_hot if thermal else 0:.0f} -> "
        f"{ecfg.t_cold if thermal else 0:.0f} K, B = {field} T, "
        f"{n_replicas} replicas x {st.pos.shape[0]} atoms "
        f"[{type(plan).__name__} plan] ===")
    t0 = time.perf_counter()
    eng.run(steps, spawn_generators(seed, n_replicas, dev), chunk=ecfg.chunk)
    charge = np.asarray(eng.trace.values["charge"])   # (chunks, replicas)
    for c in range(charge.shape[0]):
        t_c = eng.trace.time[c]
        qs = " ".join(f"{q:+6.2f}" for q in charge[c])
        log(f"  t={t_c:6.2f} ps  T={float(temp.at(t_c)):5.1f} K  Q per "
            f"replica: [{qs}]  ({time.perf_counter() - t0:.1f}s)")
    return charge


def summarize(q_thermal, q_cold) -> dict:
    """Per replica max |Q| over the settled half of each run, and the
    nucleation fraction (replicas with max |Q| > 0.5)."""
    half = q_cold.shape[0] // 2
    out = {"cold_max_abs_q": np.abs(q_cold[half:]).max(axis=0).tolist()}
    if q_thermal is not None:
        q_th = np.abs(q_thermal[half:]).max(axis=0)
        out.update(thermal_max_abs_q=q_th.tolist(),
                   nucleation_fraction=float((q_th > 0.5).mean()))
    return out


def main() -> int:
    from repro_torch.configs.fege_spinlattice import nucleation_ensemble
    ecfg = nucleation_ensemble()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=ecfg.n_steps)
    ap.add_argument("--replicas", type=int, default=ecfg.n_replicas)
    ap.add_argument("--field", type=float, default=ecfg.b_field,
                    help="Tesla (reduced-scale analogue of 0.1-0.2 T)")
    ap.add_argument("--cold", action="store_true",
                    help="run only the no-thermal-activation control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    q_thermal = None
    if not args.cold:
        q_thermal = run(True, args.steps, args.replicas, args.field,
                        device=args.device)
    # the cold control is deterministic (no thermostat noise), so replicas
    # would be identical: one is enough
    q_cold = run(False, args.steps, 1, args.field, device=args.device)
    s = summarize(q_thermal, q_cold)
    print("\n=== ensemble statistics, settled half of the run ===")
    print(f"cold    |Q|_max per replica = {np.round(s['cold_max_abs_q'], 2)} "
          "(helix intact: the field alone cannot break it)")
    if q_thermal is not None:
        print(f"thermal |Q|_max per replica = "
              f"{np.round(s['thermal_max_abs_q'], 2)}")
        print(f"nucleation fraction = {s['nucleation_fraction']:.2f} of "
              f"{args.replicas} replicas")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
