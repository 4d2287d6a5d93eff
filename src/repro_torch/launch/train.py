"""Training and simulation driver (port of the ``fege-spinlattice`` half of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch fege-spinlattice \\
        --steps 500 --cells 6 --temperature 160

Fits NEP-SPIN to synthetic constrained-DFT data (24 B20 2x2x2
configurations labeled by the Heisenberg-DMI oracle, Adam for
``--fit-steps``), then runs coupled spin-lattice MD with the fitted weights
on a ``--cells``^3 B20 supercell, printing E, T and the topological charge
every 50 steps and the helix pitch at the end.  ``--use-kernel`` (the
default on a card) routes the MD through the hand-written K1/K2 kernels
(``NEPSpinPotential(use_kernel=True)``); ``--device cpu`` runs on the host.

The LM half (``--arch`` of the LM zoo) is ROADMAP queue 1 item 15.6 and
raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.utils.device import resolve_device

MD_ARCH = "fege-spinlattice"


def train_lm(args):
    raise NotImplementedError(
        f"LM training (--arch {args.arch}) is ROADMAP queue 1 item 15.6: "
        "chunked_xent, make_loss_fn, train/train_step.py; only "
        f"--arch {MD_ARCH} runs in the port")


def fit_potential(args, generator, device, dtype):
    """The synthetic dataset and the Adam fit of train_md: returns
    (spec, params, dataset, loss history)."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.core.training import fit_adam, generate_dataset
    from repro_torch.md.lattice import b20_fege

    oracle = HeisenbergDMIModel(r0=2.45, morse_de=0.4, morse_alpha=1.6,
                                d0=args.d_over_j * 0.0166)
    spec = NEPSpinSpec(l_max=2, n_ang=2, n_rad=4, n_spin=3, basis_size=6)
    ds = generate_dataset(oracle, b20_fege(), (2, 2, 2), 24, generator,
                          dtype=dtype, device=device)
    params, hist = fit_adam(spec, ds, generator, steps=args.fit_steps)
    return spec, params, ds, hist


def train_md(args, *, keep: dict | None = None) -> dict:
    """Fit, then MD with the fitted weights (the reference's ``train_md``);
    returns the fit's RMSEs and losses and the run's per-chunk numbers.
    ``keep`` (a dict) receives the ``Simulation`` under ``"sim"``."""
    from repro_torch.core.potential import NEPSpinPotential
    from repro_torch.core.training import rmse_metrics
    from repro_torch.md.analysis import helix_pitch, topological_charge
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.simulate import Simulation
    from repro_torch.md.state import init_state, temperature_of

    dev = resolve_device(args.device)
    dtype = torch.float32
    use_kernel = (dev.type == "cuda") if args.use_kernel is None \
        else args.use_kernel
    g = torch.Generator(device=dev).manual_seed(args.seed)
    lat = b20_fege()

    print("generating synthetic constrained-DFT data + fitting NEP-SPIN...")
    t0 = time.perf_counter()
    spec, params, ds, hist = fit_potential(args, g, dev, dtype)
    fit_s = time.perf_counter() - t0
    fit = rmse_metrics(spec, params, ds)
    print("fit:", fit)

    st = init_state(lat, (args.cells,) * 3, generator=g,
                    temperature=args.temperature, spin_init="helix_x",
                    dtype=dtype, device=dev)
    masses = torch.tensor(lat.masses, dtype=dtype, device=dev)
    moments = torch.tensor(lat.moments, dtype=dtype, device=dev)
    icfg = IntegratorConfig(dt=2e-3, temperature=args.temperature,
                            lattice_gamma=2.0, spin_alpha=0.05,
                            spin_longitudinal=0.05)
    sim = Simulation(
        potential=NEPSpinPotential(spec, params, moments,
                                   use_kernel=use_kernel),
        cfg=icfg, state=st, masses=masses, magnetic=moments > 0,
        cutoff=spec.cutoff, capacity=64, use_cell_list=True,
        cell_capacity=32,
        field=torch.tensor([0.0, 0.0, args.field], dtype=dtype, device=dev),
        device=dev)
    if keep is not None:
        keep["sim"] = sim
    temps = []

    def per_chunk(state, ff):
        temps.append(float(temperature_of(state, masses)))

    rows = []
    md_s = 0.0
    for block in range(args.steps // 50):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(50, g, chunk=25, callback=per_chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        md_s += time.perf_counter() - t0
        q = float(topological_charge(sim.state.pos, sim.state.spin,
                                     sim.state.box))
        rows.append({"step": (block + 1) * 50, "energy": sim.energy,
                     "temperature": temps[-1], "charge": q})
        print(f"step {(block + 1) * 50:5d} E {sim.energy:10.4f} "
              f"T {temps[-1]:6.1f}K Q {q:+.2f}  ({md_s:.1f}s)")
    pitch = float(helix_pitch(sim.state.pos, sim.state.spin, sim.state.box))
    print(f"pitch: {pitch:.1f} A")
    steps = 50 * (args.steps // 50)
    return {"spec": spec, "fit": fit, "loss_first": hist[0],
            "loss_last": hist[-1], "fit_s": fit_s,
            "n_atoms": int(st.pos.shape[0]), "use_kernel": use_kernel,
            "steps": steps, "md_s": md_s,
            "steps_per_s": steps / md_s if md_s > 0 else None,
            "chunk_temperatures": temps, "rows": rows, "pitch": pitch,
            "rebuilds": sim.n_rebuilds}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # MD options (the reference's defaults)
    ap.add_argument("--cells", type=int, default=6)
    ap.add_argument("--temperature", type=float, default=160.0)
    ap.add_argument("--field", type=float, default=0.1)
    ap.add_argument("--d-over-j", type=float, default=0.3)
    ap.add_argument("--fit-steps", type=int, default=150)
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=None, help="MD through K1/K2 (default: on a "
                    "CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.arch == MD_ARCH:
        return train_md(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
