#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits nonzero, printing
no result, without them.  Phases (each raises on failure):

1. the card's name and power limit; build every kernel from ``csrc/``;
2. each kernel against its plain PyTorch version on B20 8x8x8 (4,096 atoms,
   0.08 A thermal jitter, random spins, production spec, capacity 64): f64
   within 1e-9 and f32 within 1e-4 of each output's max |ref|; and
   ``nep_compute`` through the kernels against the autograd ``compute``;
3. the main path: ``Engine`` with ``NEPSpinPotential(use_kernel=True)`` on
   32x32x32 B20 cells (262,144 atoms) for 3 chunks x 20 steps at 300 K in a
   0.2 T field; launch counts must equal 1 + steps + rebuilds (one
   evaluation at construction, one per step, one per rebuild);
4. each kernel against its plain version at the main path's shapes (f32,
   1e-4), and times of both with CUDA events, beside the least time the card
   could take (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s);
5. one ``{"kernels": [...]}`` line, then ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
KERNELS = {
    "nep_atom_pass": dict(
        source="src/repro_torch/kernels/nep/csrc/nep_atom_pass.cu",
        replaces="src/repro/kernels/nep/kernel.py:194"),
    "nep_force_pass": dict(
        source="src/repro_torch/kernels/nep/csrc/nep_force_pass.cu",
        replaces="src/repro/kernels/nep/kernel.py:379"),
}


def log(*args):
    print(*args, flush=True)


def rel_err(got, want) -> float:
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-300)


def check(name, got, want, bar):
    err = rel_err(got, want)
    log(f"  {name:<28} rel err {err:.3e} (bar {bar:g})")
    if not err < bar:
        raise AssertionError(f"{name}: relative error {err:.3e} >= {bar:g}")
    return err


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ---------------------------------------------------------------------------
# analytic work of one call, counted over this run's pairs inside the cutoff
# ---------------------------------------------------------------------------

def flops_atom_pass(spec, n_atoms, n_pairs) -> float:
    """K1: per pair the distance, basis, carriers and accumulation; per atom
    finalize, the MLP forward and backward, and the adjoints."""
    k, nm = spec.basis_size, (spec.l_max + 1) * (spec.l_max + 2) * (
        spec.l_max + 3) // 6
    d = spec.n_desc
    pair = (18 + 6 * k + 2 * spec.n_rad * k + 12 + 2 * nm
            + spec.n_ang * (2 * k + 2 * nm))
    atom = 3 * spec.n_ang * nm + 4 * d * spec.hidden + 6 * spec.hidden
    if spec.spin:
        pair += 30 + spec.n_spin * (2 * k + 18)
        atom += 20 * spec.n_spin + 4 * spec.n_onsite
    return float(pair * n_pairs + atom * n_atoms)


def flops_force_pass(spec, n_atoms, n_pairs) -> float:
    """K2: per pair the distance, basis and its derivative, both halves'
    coefficient sums, the angular and spin contractions, the rhat gradient
    and the projection onto dr."""
    k, nm = spec.basis_size, (spec.l_max + 1) * (spec.l_max + 2) * (
        spec.l_max + 3) // 6
    pair = (21 + 12 * k + 4 * spec.n_rad * k + 12 + 2 * nm
            + spec.n_ang * (8 * k + 9 * nm) + 15 * nm + 2 * k + 24)
    if spec.spin:
        pair += 75 + spec.n_spin * (8 * k + 47)
    return float(pair * n_pairs + 6 * n_atoms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build
    from repro_torch.configs.fege_spinlattice import config, main_path
    from repro_torch.core.potential import (NEPSpinParams, NEPSpinPotential,
                                            compute, init_params)
    from repro_torch.kernels.nep import kernel as kern
    from repro_torch.kernels.nep import ref
    from repro_torch.kernels.nep.layout import unpack_abar
    from repro_torch.kernels.nep.ops import nep_compute
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.neighbor import cell_neighbor_table, gather_blocks
    from repro_torch.md.state import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: card, build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"phase 1: built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per library: { {k: round(v, 1) for k, v in secs.items()} })")
    for name in KERNELS:
        report = _build.library_path(name).with_suffix(".log").read_text()
        for line in report.splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"  ptxas {name}: {line.strip()}")

    spec = config().spec
    lat = b20_fege()
    moments = torch.tensor([1.16, 0.0], device=dev)

    # ---- phase 2: kernels vs plain versions, 4,096 atoms --------------------
    log("phase 2: kernels vs plain versions, B20 8x8x8, production spec")
    errs = {name: {} for name in KERNELS}
    gen = torch.Generator(device=dev).manual_seed(7)
    p64 = init_params(spec, gen, dtype=torch.float64, device=dev)
    for dtype, bar, tag in ((torch.float64, 1e-9, "f64"),
                            (torch.float32, 1e-4, "f32")):
        g = torch.Generator(device=dev).manual_seed(11)
        st = init_state(lat, (8, 8, 8), generator=g, spin_init="random",
                        dtype=dtype, device=dev)
        pos = torch.remainder(st.pos + 0.08 * torch.randn(
            st.pos.shape, generator=g, dtype=dtype, device=dev), st.box)
        params = NEPSpinParams(*(p.to(dtype) for p in p64))
        tab = cell_neighbor_table(pos, st.box, spec.cutoff, 64,
                                  cell_capacity=32)
        nbh = gather_blocks(pos, st.types, tab, st.box)
        sj = st.spin[nbh.idx.long()]
        blocks = (nbh.dr, nbh.mask, st.types, nbh.tj, st.spin, sj)
        got = kern.nep_atom_pass(spec, params, *blocks)
        want = ref.atom_pass_plain(spec, params, *blocks)
        torch.cuda.synchronize()
        worst = max(check(f"K1 e {tag}", got[0], want[0], bar),
                    check(f"K1 hdir {tag}", got[1], want[1], bar))
        gl, wl = unpack_abar(spec, got[2]), unpack_abar(spec, want[2])
        for k in wl:
            worst = max(worst, check(f"K1 abar.{k} {tag}", gl[k], wl[k], bar))
        errs["nep_atom_pass"][tag] = worst
        fk = kern.nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx,
                                 st.types, nbh.tj, st.spin, sj, want[2])
        fp = ref.force_pass_plain(spec, params, nbh.dr, nbh.mask, nbh.idx,
                                  st.types, nbh.tj, st.spin, sj, want[2])
        torch.cuda.synchronize()
        errs["nep_force_pass"][tag] = max(
            check(f"K2 F {tag}", fk[0], fp[0], bar),
            check(f"K2 h2 {tag}", fk[1], fp[1], bar))
        field = torch.tensor([0.0, 0.0, 0.2], dtype=dtype, device=dev)
        mom = moments.to(dtype)
        ek = nep_compute(spec, params, nbh, st.spin, st.types, field, mom)
        ea = compute(spec, params, nbh, st.spin, st.types, field, mom)
        for name, a, b in zip("EFH", ek, ea):
            check(f"nep_compute {name} {tag}", a, b, bar)

    # ---- phase 3: the main path ---------------------------------------------
    run = main_path()
    log(f"phase 3: Engine main path, B20 {run.unit_cells} = {run.n_atoms} "
        f"atoms, {run.chunks} x {run.chunk} steps, T={run.temperature} K, "
        f"B={run.field} T")
    dtype = getattr(torch, run.dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    state = init_state(lat, run.unit_cells, generator=g,
                       temperature=run.temperature, dtype=dtype, device=dev)
    params = init_params(spec, g, dtype=dtype, device=dev)
    pot = NEPSpinPotential(spec, params, moments.to(dtype), use_kernel=True)
    cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                           spin_alpha=run.spin_alpha)
    masses = torch.tensor(lat.masses, dtype=dtype, device=dev)
    magnetic = torch.tensor(lat.moments, device=dev) > 0
    kern.nep_atom_pass.launches = 0
    kern.nep_force_pass.launches = 0
    t0 = time.perf_counter()
    eng = Engine(pot, cfg, state, masses, magnetic, spec.cutoff,
                 temperature=run.temperature, field=run.field,
                 capacity=run.capacity, skin=run.skin, use_cell_list=True,
                 cell_capacity=run.cell_capacity, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = run.chunks * run.chunk
    t0 = time.perf_counter()
    eng.run(steps, g, chunk=run.chunk)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"nep_atom_pass": kern.nep_atom_pass.launches,
                "nep_force_pass": kern.nep_force_pass.launches}
    st, ff = eng.state, eng._ff
    expect = 1 + steps + eng.n_rebuilds
    log(f"  grid {eng._n_cells}, setup {setup_s:.2f} s, {steps} steps in "
        f"{run_s:.3f} s = {steps / run_s:.3f} steps/s, "
        f"rebuilds {eng.n_rebuilds}, launches {launches} "
        f"(expect {expect} each)")
    for name, n in launches.items():
        if n != expect:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"1 + steps + rebuilds = {expect}")
    for name, t in (("pos", st.pos), ("vel", st.vel), ("spin", st.spin),
                    ("force", ff.force), ("field", ff.field)):
        if t.shape != (run.n_atoms, 3) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or "
                                 "non-finite values")
    fe = magnetic[st.types.long()]
    spin_dev = float((torch.linalg.norm(st.spin[fe], dim=-1) - 1).abs().max())
    log(f"  state finite; {int(fe.sum())} Fe spins, max ||S|-1| = "
        f"{spin_dev:.3e}; energy {float(ff.energy):.6f} eV; "
        f"observables {[(k, v.tolist()) for k, v in eng.trace.values.items()]}")
    if not spin_dev < 1e-4:
        raise AssertionError(f"|S| drifted by {spin_dev}")

    # ---- phase 4: at the main path's shapes: compare, time, bound ----------
    log("phase 4: kernels at the main path's shapes (f32)")
    c = eng._carry
    nbh, spin, types = c.nbh, c.state.spin, c.state.types
    sj = spin[nbh.idx.long()]
    blocks = (nbh.dr, nbh.mask, types, nbh.tj, spin, sj)
    n_atoms = spin.shape[0]
    r = torch.sqrt((nbh.dr * nbh.dr).sum(-1) + 1e-12)
    n_pairs = int((nbh.mask & (r < spec.cutoff)).sum())
    log(f"  {n_atoms} atoms x {nbh.mask.shape[1]} slots, "
        f"{int(nbh.mask.sum())} pairs in the table, {n_pairs} inside the "
        "cutoff")
    k1 = kern.nep_atom_pass(spec, params, *blocks)
    p1 = ref.atom_pass_plain(spec, params, *blocks)
    k2 = kern.nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                             nbh.tj, spin, sj, p1[2])
    p2 = ref.force_pass_plain(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                              nbh.tj, spin, sj, p1[2])
    torch.cuda.synchronize()
    main_err = {
        "nep_atom_pass": (max(check(f"K1 {o} main", a, b, 1e-4) for o, a, b
                              in zip(("e", "hdir", "abar"), k1, p1)),
                          max(float((a - b).abs().max())
                              for a, b in zip(k1, p1))),
        "nep_force_pass": (max(check(f"K2 {o} main", a, b, 1e-4) for o, a, b
                               in zip(("F", "h2"), k2, p2)),
                           max(float((a - b).abs().max())
                               for a, b in zip(k2, p2))),
    }
    k1_args = (spec, params, *blocks)
    k2_args = (spec, params, nbh.dr, nbh.mask, nbh.idx, types, nbh.tj, spin,
               sj, k1[2])
    ms = {"nep_atom_pass": time_ms(torch, lambda: kern.nep_atom_pass(
              *k1_args), 20),
          "nep_force_pass": time_ms(torch, lambda: kern.nep_force_pass(
              *k2_args), 20)}
    plain_ms = {"nep_atom_pass": time_ms(torch, lambda: ref.atom_pass_plain(
                    *k1_args), 2),
                "nep_force_pass": time_ms(torch, lambda: ref.force_pass_plain(
                    *k2_args), 2)}
    pbytes = nbytes(*params)
    work = {
        "nep_atom_pass": (
            nbytes(*blocks, *k1) + pbytes,
            flops_atom_pass(spec, n_atoms, n_pairs)),
        "nep_force_pass": (
            nbytes(nbh.dr, nbh.mask, nbh.idx, types, nbh.tj, spin, sj, k1[2],
                   *k2) + nbytes(params.c_rad, params.c_ang, params.c_spin),
            flops_force_pass(spec, n_atoms, n_pairs)),
    }
    step_ms = 1e3 * run_s / steps
    rows = []
    for name, meta in KERNELS.items():
        b, f = work[name]
        t_bytes, t_ops = 1e3 * b / HBM_BYTES_PER_S, 1e3 * f / F32_FLOPS_PER_S
        bound = max(t_bytes, t_ops)
        log(f"  {name}: {ms[name]:.3f} ms (plain {plain_ms[name]:.1f} ms); "
            f"{b / 1e6:.1f} MB -> {t_bytes:.4f} ms, {f / 1e9:.2f} GFLOP -> "
            f"{t_ops:.4f} ms; bound {bound:.4f} ms = "
            f"{100 * bound / ms[name]:.2f}% of the kernel's time")
        rows.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": main_err[name][1],
            "max_rel_err_f32": max(errs[name]["f32"], main_err[name][0]),
            "max_rel_err_f64": errs[name]["f64"],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    log(f"  main path step {step_ms:.2f} ms, of which K1 + K2 "
        f"{ms['nep_atom_pass'] + ms['nep_force_pass']:.2f} ms per evaluation")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
