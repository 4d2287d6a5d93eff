#!/usr/bin/env python3
"""Throughput against system size, the paper's Fig. 6 / Table I (port of
``benchmarks/throughput.py``).

    PYTHONPATH=src python -m repro_torch.launch.throughput [--kernel]
        [--smoke] [--device cuda|cpu] [--out DIR]

Atom-steps/s of one whole coupled step (``md/integrator.py:make_step``: the
neighbour gather, the autograd NEP-SPIN evaluation at the reference's small
spec, the integrator and both thermostats at 160 K), with s/step/atom (the
paper's TtS) and TtS per model parameter (``utils/tree.py:tree_count``).
B20 FeGe, f32, capacity 64, the table built outside the timed step (dense
up to 8^3 unit cells, linked-cell above).  Sizes: the reference's 3, 4, 6
and 8 unit cells a side (3 and 4 under ``--smoke``); on the card 8, 16, 24,
32 and 48 (up to 884,736 atoms).  A size that runs out of memory ends the
sweep: the largest N that ran is recorded beside each size's peak memory.

``--kernel`` adds rows through ``NEPSpinPotential(use_kernel=True)``, the
reference's own production evaluator, so K1 and K2 run; the bodies they
launch in are recorded, and on the card a kernel that did not launch fails
the run (the small spec, with hidden 32, is the md_loop
scenario's, which has warp bodies).  Also printed: the TtS of the largest
N over that of the smallest (the reference's O(N) remark).  Writes
``throughput.json`` under ``--out``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch import bench_common as bc

SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
CPU_CELLS = (3, 4, 6, 8)
SMOKE_CELLS = (3, 4)
CARD_CELLS = (8, 16, 24, 32, 48)
CAPACITY = 64
TEMPERATURE = 160.0


def model(device):
    """(spec, params, parameter count) of the reference's small spec."""
    from repro_torch.utils.tree import tree_count
    spec, params = bc.nep_model(device, 0, **SPEC)
    return spec, params, tree_count(params)


def time_step(dev, spec, params, cells: int, kernel: bool) -> dict:
    """Seconds of one timed step at ``cells`` (after the first evaluation)."""
    from repro_torch.core.potential import NEPSpinPotential
    from repro_torch.md.integrator import (ForceField, IntegratorConfig,
                                           make_step)
    from repro_torch.md.lattice import b20_fege
    lat = b20_fege()
    st = bc.b20_state(dev, cells, TEMPERATURE, 1)
    tab = bc.neighbor_table(st, cells, spec.cutoff, CAPACITY)
    pot = NEPSpinPotential(spec, params, use_kernel=kernel)
    icfg = IntegratorConfig(dt=1e-3, temperature=TEMPERATURE,
                            lattice_gamma=1.0, spin_alpha=0.05)

    def evaluate(pos, spin):
        return ForceField(*pot.energy_forces_field(pos, spin, st.types, tab,
                                                   st.box))

    step = make_step(evaluate, icfg,
                     torch.tensor(lat.masses, dtype=torch.float32,
                                  device=dev),
                     torch.tensor(lat.moments, device=dev) > 0)
    ff = evaluate(st.pos, st.spin)
    gen = torch.Generator(device=dev)
    t = bc.timeit(lambda: step(st, ff, gen.manual_seed(2)), device=dev)
    return {"n_atoms": int(st.pos.shape[0]), "s": t}


def sweep(dev, spec, params, n_param: int, cells, kernel: bool) -> dict:
    """Each size in turn until one runs out of memory."""
    tag = "kernel/" if kernel else ""
    res, rows = {}, []
    for c in cells:
        bc.reset_peak(dev)
        try:
            r = time_step(dev, spec, params, c, kernel)
        except Exception as e:      # noqa: BLE001 - the size's cut
            if not bc.is_oom(e):
                raise
            res[str(c)] = {"cells": c, "oom": True}
            print(f"throughput: {tag}B20 {c}^3 ran out of memory; the "
                  "sweep ends", flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            break
        n, t = r["n_atoms"], r["s"]
        r.update(cells=c, atom_steps_per_s=n / t, tts=t / n,
                 tts_per_param=t / n / n_param, peak_gib=bc.peak_gib(dev))
        res[str(c)] = r
        rows.append(bc.row(
            f"throughput/{tag}N={n}", t * 1e6,
            f"{n / t:.3e} atom-step/s|{t / n:.3e} s/step/atom|"
            f"{t / n / n_param:.3e} s/(atom*param*step)"
            + (f"|{r['peak_gib']:.2f}GiB" if r["peak_gib"] else "")))
    ran = [r for r in res.values() if not r.get("oom")]
    out = {"sizes": res, "rows": rows,
           "largest_n": max(r["n_atoms"] for r in ran) if ran else None}
    if len(ran) > 1:
        out["tts_ratio_largest_over_smallest"] = ran[-1]["tts"] / ran[0][
            "tts"]
        rows.append(bc.row(
            f"throughput/{tag}O(N)", 0.0,
            f"TtS(N={ran[-1]['n_atoms']})/TtS(N={ran[0]['n_atoms']})="
            f"{out['tts_ratio_largest_over_smallest']:.2f}|largest "
            f"N={out['largest_n']}"))
    return out


def run(device="cuda", kernel: bool = False) -> dict:
    from repro_torch.kernels.nep import kernel as kern
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    cells = (SMOKE_CELLS if bc.smoke() else
             CARD_CELLS if dev.type == "cuda" else CPU_CELLS)
    spec, params, n_param = model(dev)
    out = {"device": str(dev), "cells": list(cells), "n_params": n_param,
           "spec": SPEC, "autodiff": sweep(dev, spec, params, n_param, cells,
                                           False)}
    if kernel:
        for fn in (kern.nep_atom_pass, kern.nep_force_pass):
            fn.launches = 0
            fn.body_launches = dict.fromkeys(kern.BODIES, 0)
        out["kernel"] = sweep(dev, spec, params, n_param, cells, True)
        out["kernel"]["bodies"] = {"K1": kern.atom_pass_body(spec),
                                   "K2": kern.force_pass_body(spec)}
        out["kernel"]["launches"] = {
            fn.__name__: dict(total=fn.launches, **fn.body_launches)
            for fn in (kern.nep_atom_pass, kern.nep_force_pass)}
        idle = [k for k, v in out["kernel"]["launches"].items()
                if v["total"] == 0]
        if dev.type == "cuda" and idle:
            raise AssertionError(f"throughput --kernel launched no {idle}")
    out["rows"] = [r for k in ("autodiff", "kernel") if k in out
                   for r in out[k].pop("rows")]
    return out


def main(argv=None) -> dict:
    ap = bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    ap.add_argument("--kernel", action="store_true",
                    help="also through K1 / K2 (use_kernel=True)")
    args = bc.parse(ap, argv)
    with bc.switches(args):
        out = run(args.device, args.kernel)
    bc.write_json(args.out / "throughput.json", out)
    return out


if __name__ == "__main__":
    main()
