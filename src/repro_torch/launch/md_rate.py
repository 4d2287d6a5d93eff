#!/usr/bin/env python3
"""Steps/s of the MD main path, several runs in one process, on the card.

    PYTHONPATH=src python3 src/repro_torch/launch/md_rate.py [--repeats 3]

Builds K1 and K2, then runs ``configs/fege_spinlattice.py:main_path()``
(262,144 atoms of B20 FeGe, production spec, f32, 300 K, 0.2 T, 3 chunks x
20 steps, K1/K2) ``--repeats`` times, each in a fresh Engine from the same
seed, and prints the card's name and power limit and one JSON line: the
steps/s of every run (host wall time ending in a synchronize; the first
run also holds the first launch of every integrator kernel) and the
rebuild count.

It uses only what the port has had since its first slice, so two trees can
be compared in one call: run this file with ``PYTHONPATH`` set to each
tree's ``src`` in turns (A, B, B, A).  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import torch

    import repro_torch
    from repro_torch import _build
    from repro_torch.configs.fege_spinlattice import config, main_path
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.state import init_state

    if not torch.cuda.is_available():
        raise SystemExit("md_rate needs a CUDA card")
    _build.build(["nep_atom_pass", "nep_force_pass"])
    dev = torch.device("cuda")
    spec, lat, run = config().spec, b20_fege(), main_path()
    steps = 3 * 20
    rates, rebuilds = [], None
    for _ in range(args.repeats):
        g = torch.Generator(device=dev).manual_seed(0)
        state = init_state(lat, run.unit_cells, generator=g,
                           temperature=run.temperature, device=dev)
        params = init_params(spec, g, device=dev)
        pot = NEPSpinPotential(spec, params,
                               torch.tensor([1.16, 0.0], device=dev),
                               use_kernel=True)
        cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                               spin_alpha=run.spin_alpha)
        eng = Engine(pot, cfg, state,
                     torch.tensor(lat.masses, dtype=torch.float32,
                                  device=dev),
                     torch.tensor(lat.moments, device=dev) > 0, spec.cutoff,
                     temperature=run.temperature, field=run.field,
                     capacity=run.capacity, skin=run.skin,
                     use_cell_list=True, cell_capacity=run.cell_capacity,
                     device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(steps, g, chunk=20)
        torch.cuda.synchronize()
        rates.append(steps / (time.perf_counter() - t0))
        rebuilds = eng.n_rebuilds
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({"package": repro_torch.__file__,
                      "steps_per_s": rates, "rebuilds": rebuilds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
