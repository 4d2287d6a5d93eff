"""Paper Table IV analogue: accuracy of NEP-SPIN against baselines on a
held-out FeGe spin-lattice validation set labeled by the synthetic
constrained-DFT oracle (port of ``benchmarks/accuracy.py``).

    PYTHONPATH=src python -m repro_torch.launch.accuracy [--steps 150]
        [--device cuda|cpu] [--out DIR]

Models compared:
  nepspin        the spin-aware NEP (the paper's model)
  nep-nospin     structural NEP without magnetic channels: its field RMSE
                 stays at the label scale, which is why the spin extension
                 is needed
  classical-fit  the fixed-coupling spin Hamiltonian with (J0, D0) chosen
                 by a 6 x 6 scan for the least field RMSE: the
                 "DFT-parameterized spin Hamiltonian" baseline

One CSV row per model: name, us_per_call (the fit's seconds x 1e6),
E/F/H RMSEs.  With ``--out`` the numbers also go to ``accuracy.json``
there.  The fit is the measurement, so the smoke switch cuts nothing
here (the reference's driver fits its 150 steps under it too).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch import bench_common as bc
from repro_torch.utils.device import resolve_device

# the oracle of benchmarks/accuracy.py
ORACLE = dict(r0=2.45, morse_de=0.4, morse_alpha=1.6, d0=0.005, kpd=0.001)
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=3, basis_size=6)


def datasets(device, dtype=torch.float32, n_train: int = 24,
             n_val: int = 8):
    """(train, validation) on B20 2x2x2 from the oracle, seeds 0 and 99."""
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.core.training import generate_dataset
    from repro_torch.md.lattice import b20_fege
    lat, oracle = b20_fege(), HeisenbergDMIModel(**ORACLE)
    train = generate_dataset(oracle, lat, (2, 2, 2), n_train,
                             torch.Generator(device=device).manual_seed(0),
                             dtype=dtype, device=device)
    val = generate_dataset(oracle, lat, (2, 2, 2), n_val,
                           torch.Generator(device=device).manual_seed(99),
                           dtype=dtype, device=device)
    return train, val


def classical_fit(val) -> dict:
    """The (J0, D0) of the 6 x 6 scan with the least field RMSE on ``val``,
    and its E/F/H RMSEs."""
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md.neighbor import dense_neighbor_table
    best, best_rmse = None, np.inf
    n = val.pos.shape[1]
    for j0 in np.linspace(0.008, 0.03, 6):
        for d0 in np.linspace(0.0, 0.01, 6):
            cand = HeisenbergDMIModel(r0=2.45, morse_de=0.4,
                                      morse_alpha=1.6, j0=float(j0),
                                      d0=float(d0))
            out = [cand.energy_forces_field(
                p, s, val.types,
                dense_neighbor_table(p, val.box, cand.cutoff, 64), val.box)
                for p, s in zip(val.pos, val.spin)]
            e, f, h = (torch.stack(x) for x in zip(*out))
            r = float(torch.sqrt(torch.mean((h - val.h_ref) ** 2)))
            if r < best_rmse:
                best_rmse, best = r, (float(j0), float(d0), e, f, h)
    j0, d0, e, f, h = best
    return {"e_rmse_per_atom": float(torch.sqrt(torch.mean(
                (e - val.e_ref) ** 2))) / n,
            "f_rmse": float(torch.sqrt(torch.mean((f - val.f_ref) ** 2))),
            "h_rmse": best_rmse, "j0": j0, "d0": d0}


def main(argv=None) -> dict:
    """The three models' validation RMSEs and fit seconds (and, for the
    NEP fits, the fitted parameters and the loss history)."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.training import fit_adam, rmse_metrics
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", default=None,
                    help="write accuracy.json to this directory")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    train, val = datasets(dev)
    out = {}
    for name, kw in (("nepspin", {}), ("nep-nospin", {"spin": False})):
        spec = NEPSpinSpec(**SPEC, **kw)
        t0 = time.perf_counter()
        params, hist = fit_adam(spec, train,
                                torch.Generator(device=dev).manual_seed(0),
                                steps=args.steps)
        dt = time.perf_counter() - t0
        m = rmse_metrics(spec, params, val)
        out[name] = dict(m, fit_s=dt, params=params, spec=spec, loss=hist)
        bc.row(f"accuracy/{name}", dt * 1e6,
            f"E={m['e_rmse_per_atom'] * 1e3:.3f}meV/atom|"
            f"F={m['f_rmse'] * 1e3:.2f}meV/A|"
            f"H={m['h_rmse'] * 1e3:.2f}meV/muB")
    t0 = time.perf_counter()
    c = classical_fit(val)
    c["fit_s"] = time.perf_counter() - t0
    out["classical-fit"] = c
    bc.row("accuracy/classical-fit", c["fit_s"] * 1e6,
        f"E={c['e_rmse_per_atom'] * 1e3:.3f}meV/atom|"
        f"F={c['f_rmse'] * 1e3:.2f}meV/A|"
        f"H={c['h_rmse'] * 1e3:.2f}meV/muB|J0={c['j0']:.4f}|"
        f"D0={c['d0']:.4f}")
    if args.out is not None:
        bc.write_json(Path(args.out) / "accuracy.json", {
            "steps": args.steps, "device": str(dev),
            "models": {k: {m: v for m, v in r.items()
                           if isinstance(v, (int, float))}
                       for k, r in out.items()}})
    out["train"], out["val"] = train, val
    return out


if __name__ == "__main__":
    main()
