#!/usr/bin/env python3
"""K1 and K2 at the MD main path's shapes, for comparing two trees on the
card.

    PYTHONPATH=src python3 src/repro_torch/launch/kernel_rate.py
        --out build/ab/new.pt [--compare build/ab/old.pt] [--replicas 4]

Builds the tree's K1 and K2, makes one set of main-path-shaped inputs from
fixed seeds (B20 32x32x32 = 262,144 atoms with a 0.05 A position jitter,
random unit spins, the production spec with random weights, the
linked-cell table at capacity 64, f32), launches each kernel's default body
once, saves the outputs to ``--out``, and times each kernel with CUDA
events: the mean of two windows of 20 launches.  ``--replicas R`` (R > 1)
also makes a batch of R replicas on that table (replica 0 the flat inputs,
the others with their own random spins), holds replica r of one batched
launch bitwise against a flat launch on replica r's inputs, and times one
batched launch beside R flat launches, in turns; a tree without the
replica axis runs without it.  ``--compare`` holds the outputs the two
files share bitwise.  It prints the card's name and power limit and one
JSON line.

It uses only what the port has had since its first slice, so two trees can
be compared in one call: run this file with ``PYTHONPATH`` set to each
tree's ``src`` in turns (A, B, B, A).  Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare", default=None)
    ap.add_argument("--replicas", type=int, default=1)
    args = ap.parse_args()

    import torch

    import repro_torch
    from repro_torch import _build
    from repro_torch.configs.fege_spinlattice import config
    from repro_torch.core.potential import init_params
    from repro_torch.kernels.nep import kernel as kern
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.neighbor import cell_neighbor_table, gather_blocks
    from repro_torch.md.state import init_state

    if not torch.cuda.is_available():
        raise SystemExit("kernel_rate needs a CUDA card")
    _build.build(["nep_atom_pass", "nep_force_pass"])
    dev = torch.device("cuda")
    spec, lat = config().spec, b20_fege()
    g = torch.Generator(device=dev).manual_seed(0)
    st = init_state(lat, (32, 32, 32), generator=g, spin_init="random",
                    device=dev)
    pos = torch.remainder(st.pos + 0.05 * torch.randn(
        st.pos.shape, generator=g, device=dev), st.box)
    params = init_params(spec, g, device=dev)
    tab = cell_neighbor_table(pos, st.box, spec.cutoff, 64, cell_capacity=32)
    nbh = gather_blocks(pos, st.types, tab, st.box)
    sj = st.spin[nbh.idx.long()]
    k1_args = (spec, params, nbh.dr, nbh.mask, st.types, nbh.tj, st.spin, sj)
    k1 = kern.nep_atom_pass(*k1_args)
    k2_args = (spec, params, nbh.dr, nbh.mask, nbh.idx, st.types, nbh.tj,
               st.spin, sj, k1[2])
    k2 = kern.nep_force_pass(*k2_args)
    torch.cuda.synchronize()
    outs = {"nep_atom_pass": [t.cpu() for t in k1],
            "nep_force_pass": [t.cpu() for t in k2]}

    def window(fn, fargs, reps=20):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        fn(*fargs)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn(*fargs)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    ms = {name: [window(fn, fargs) for _ in range(2)]
          for name, fn, fargs in (("nep_atom_pass", kern.nep_atom_pass,
                                   k1_args),
                                  ("nep_force_pass", kern.nep_force_pass,
                                   k2_args))}
    result = {"package": repro_torch.__file__,
              "ms": {k: sum(v) / 2 for k, v in ms.items()}, "windows": ms}
    if args.replicas > 1:
        result["replicas"] = batched(args.replicas, kern, spec, params, st,
                                     nbh, g, window, outs)
    torch.save(outs, args.out)
    if args.compare:
        other = torch.load(args.compare)
        result["bitwise_equal"] = {
            name: all(torch.equal(a, b) for a, b in zip(outs[name],
                                                        other[name]))
            for name in outs if name in other}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps(result))
    return 0


def batched(nr, kern, spec, params, st, nbh, g, window, outs) -> dict:
    """One launch over ``nr`` replicas sharing the table beside ``nr`` flat
    launches: replica r bitwise the flat launch, and both timed in turns
    (batched, flat, flat, batched); the batched outputs go into ``outs``."""
    import torch
    live = st.spin.norm(dim=-1, keepdim=True) > 0
    spin = torch.stack([st.spin] + [torch.nn.functional.normalize(
        torch.randn(st.spin.shape, generator=g, device=st.spin.device),
        dim=-1) * live for _ in range(nr - 1)])
    dr = nbh.dr.expand(nr, *nbh.dr.shape).contiguous()
    sj = spin[:, nbh.idx.long()]
    k1_args = (spec, params, dr, nbh.mask, st.types, nbh.tj, spin, sj)
    k1 = kern.nep_atom_pass(*k1_args)
    k2_args = (spec, params, dr, nbh.mask, nbh.idx, st.types, nbh.tj, spin,
               sj, k1[2])
    k2 = kern.nep_force_pass(*k2_args)

    def flat_args(r):
        return ((spec, params, dr[r], nbh.mask, st.types, nbh.tj, spin[r],
                 sj[r]),
                (spec, params, dr[r], nbh.mask, nbh.idx, st.types, nbh.tj,
                 spin[r], sj[r], k1[2][r]))

    bitwise = True
    for r in range(nr):
        a1, a2 = flat_args(r)
        f1, f2 = kern.nep_atom_pass(*a1), kern.nep_force_pass(*a2)
        bitwise &= all(torch.equal(b[r], f) for b, f in zip(k1 + k2,
                                                            f1 + f2))
    if not bitwise:
        raise AssertionError("a replica of the batched launch is not the "
                             "flat launch's")
    torch.cuda.synchronize()
    outs[f"nep_atom_pass_R{nr}"] = [t.cpu() for t in k1]
    outs[f"nep_force_pass_R{nr}"] = [t.cpu() for t in k2]
    res = {"n_replicas": nr, "bitwise_vs_flat": bitwise}
    for i, (name, fn, fargs) in enumerate((
            ("nep_atom_pass", kern.nep_atom_pass, k1_args),
            ("nep_force_pass", kern.nep_force_pass, k2_args))):
        flat = [flat_args(r)[i] for r in range(nr)]
        t = {"batched": [], "flat": []}
        for how in ("batched", "flat", "flat", "batched"):
            t[how].append(window(fn, fargs) if how == "batched" else window(
                lambda: [fn(*a) for a in flat], ()))
        res[name] = {"batched_ms": sum(t["batched"]) / 2,
                     "flat_ms": sum(t["flat"]) / 2, "windows": t}
    return res


if __name__ == "__main__":
    raise SystemExit(main())
