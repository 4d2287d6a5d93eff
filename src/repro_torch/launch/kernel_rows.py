#!/usr/bin/env python3
"""Kernel-level rows: the fused paths against their plain counterparts
(port of ``benchmarks/kernels.py``).

    PYTHONPATH=src python -m repro_torch.launch.kernel_rows [--cells N]
        [--smoke] [--device cuda|cpu] [--out DIR]

* **NEP.** One whole evaluation by autograd
  (``core/potential.py:energy_forces_field``) against the fused path
  (``kernels/nep/ops.py:nep_energy_forces_field``), with atoms/s and the
  speed-up, then its stages at the same geometry: the ``sj`` gather, K1
  ``nep_atom_pass`` and K2 ``nep_force_pass``, each with its FLOPs and bytes
  (``launch/roofline.py:nep_stages``: the pairs inside the cutoff) and
  GFLOP/s.  On the card K1 and K2 come from ``roofline.nep_measured`` (CUDA
  events, its share of the bound), the gather on the same timer; on the CPU
  every stage is timed on the host's clock, with no bound.  K2 reads each neighbour's adjoint row through
  ``idx``, so the reference's ``adjoint-gather`` stage has no counterpart.
  B20 FeGe at ``--cells``^3 unit cells, 300 K, the production spec, f32,
  capacity 64: the reference's 4^3 on the CPU and under ``--smoke``,
  32^3 (262,144 atoms, the main path's size: the autograd row peaks at
  ~23 GiB) on the card; the linked-cell table above 8^3.
* **Attention.** ``flash_attention_plain`` against
  ``models/attention.py:chunked_attention(kv_chunk=512)`` at B 1, S 2,048,
  8 / 2 heads of 64, f32, causal.
* **SSD.** ``ssd_reference`` (the per-step recurrence) against
  ``ssd_chunked``: B 1, S 2,048, H 8, P 32, G 1, N 32, chunk 128, f32.
* **On the card** the hand-written FA (``kernels/attention/kernel.py:
  flash_attention``) and SSD (``kernels/ssd/ops.py:ssd_chunked_kernel``)
  get rows beside these, held against the plain rows' outputs, and every
  kernel's launches in the rows are counted by body; a kernel that did
  not launch fails the run.

On the CPU every wrapper takes its plain version: the fused NEP row is
then the plain K1 / K2 pair, which no kernel launched.  Writes
``kernel_rows.json`` under ``--out`` (default ``build/bench/``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.launch import bench_common as bc

CAPACITY = 64
CARD_CELLS = 32
ATTN = dict(b=1, s=2048, h=8, hkv=2, d=64)
SSD = dict(b=1, s=2048, h=8, p=32, g=1, n=32, chunk=128)
# a fused row against its plain counterpart on the same inputs (f32)
REL_BAR = 1e-3
# the NEP stage rows' names -> the kernels'
STAGES = {"k1-atom-pass": "nep_atom_pass", "k2-force-pass": "nep_force_pass"}


def nep_setup(device, cells: int):
    """(spec, params, state, table) of the NEP rows: the reference's seeds
    and spec (:func:`bench_common.neighbor_table`'s table)."""
    spec, params = bc.nep_model(device, 1)
    st = bc.b20_state(device, cells, 300.0, 0)
    return spec, params, st, bc.neighbor_table(st, cells, spec.cutoff,
                                               CAPACITY)


def _counters():
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.nep import kernel as nep
    from repro_torch.kernels.ssd import kernel as ssd
    return {"nep_atom_pass": nep.nep_atom_pass,
            "nep_force_pass": nep.nep_force_pass,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "ssd_chunks": ssd.ssd_chunks}


def reset_counters() -> None:
    for fn in _counters().values():
        fn.launches = 0
        fn.body_launches = dict.fromkeys(fn.body_launches, 0)


def read_counters() -> dict:
    return {name: dict(total=fn.launches, **fn.body_launches)
            for name, fn in _counters().items()}


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def bench_nep(dev, cells: int, on_card: bool) -> dict:
    from repro_torch.core.potential import energy_forces_field
    from repro_torch.kernels.nep.ops import nep_energy_forces_field
    from repro_torch.launch import roofline
    from repro_torch.md.neighbor import gather_blocks
    spec, params, st, tab = nep_setup(dev, cells)
    n = int(st.pos.shape[0])
    route = "cuda" if on_card else "plain"
    rows, out = [], {"cells": cells, "n_atoms": n, "route": route}

    def ad():
        return energy_forces_field(spec, params, st.pos, st.spin, st.types,
                                   tab, st.box)

    def kf():
        return nep_energy_forces_field(spec, params, st.pos, st.spin,
                                       st.types, tab, st.box)

    bc.reset_peak(dev)
    t_ad = bc.timeit(ad, device=dev)
    rows.append(bc.row("kernels/nep-autodiff-force", t_ad * 1e6,
                       f"{n / t_ad:.3e} atom/s"))
    t_k = bc.timeit(kf, device=dev)
    rows.append(bc.row(f"kernels/nep-fused-force/{route}", t_k * 1e6,
                       f"{n / t_k:.3e} atom/s|{t_ad / t_k:.2f}x"))
    out["parity"] = {k: _rel(a, b) for k, a, b in zip("EFH", kf(), ad())}
    out["autodiff_s"], out["fused_s"] = t_ad, t_k

    # the stages at the same geometry
    nbh = gather_blocks(st.pos, st.types, tab, st.box)
    idx = nbh.idx.long()
    gather = roofline.bound(roofline.nbytes(nbh.idx, st.spin, st.spin[idx]),
                            0.0, st.pos.dtype)
    if on_card:
        # K1 / K2 from roofline.nep_measured (CUDA events, its bounds), the
        # gather on the same timer
        meas = roofline.nep_measured(spec, params, nbh, st.spin, st.types)
        recs = {"sj-gather": {**gather, "ms": roofline.time_ms(
            lambda: st.spin[idx], 20, 2)}}
        recs |= {row: meas[k] for row, k in STAGES.items()}
        n_pairs = meas["n_pairs"]
    else:
        # the host's clock
        calls, work, n_pairs = roofline.nep_stages(spec, params, nbh,
                                                   st.spin, st.types)
        recs = {"sj-gather": {**gather, "ms": 1e3 * bc.timeit(
            lambda: st.spin[idx], device=dev)}}
        for row, k in STAGES.items():
            recs[row] = {"bytes": work[k][0], "flops": work[k][1],
                         "ms": 1e3 * bc.timeit(calls[k], device=dev)}
    out["n_pairs"], out["stages"] = n_pairs, {}
    for name, r in recs.items():
        rec = {"s": r["ms"] / 1e3, "bytes": int(r["bytes"]),
               "flops": float(r["flops"]),
               "gflop_per_s": r["flops"] / r["ms"] / 1e6}
        derived = (f"{rec['flops']:.3e}flop|{rec['bytes']:.3e}B|"
                   f"{rec['gflop_per_s']:.1f}GFLOP/s")
        if on_card:
            rec.update(bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                       share_of_bound=r["bound_ms"] / r["ms"])
            derived += f"|{100 * rec['share_of_bound']:.2f}% of bound"
        out["stages"][name] = rec
        rows.append(bc.row(f"kernels/nep-{name}/{route}", r["ms"] * 1e3,
                           derived))
    out["peak_gib"] = bc.peak_gib(dev)
    return {"rows": rows, **out}


def bench_attention(dev, on_card: bool) -> dict:
    from repro_torch.kernels.attention.kernel import (flash_attention,
                                                      flash_attention_plain)
    from repro_torch.models.attention import chunked_attention
    b, s, h, hkv, d = (ATTN[k] for k in ("b", "s", "h", "hkv", "d"))
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g, device=dev)
    k = torch.randn(b, s, hkv, d, generator=g, device=dev)
    v = torch.randn(b, s, hkv, d, generator=g, device=dev)
    pos = torch.arange(s, device=dev).expand(b, s)
    flops = 4 * b * h * s * s * d
    rows, out = [], {}
    t0 = bc.timeit(lambda: flash_attention_plain(q, k, v), device=dev)
    t1 = bc.timeit(lambda: chunked_attention(q, k, v, pos, pos,
                                             kv_chunk=512), device=dev)
    rows.append(bc.row("kernels/attention-naive", t0 * 1e6,
                       f"{flops / t0 / 1e9:.1f}GFLOP/s"))
    rows.append(bc.row("kernels/attention-flash-chunked", t1 * 1e6,
                       f"{flops / t1 / 1e9:.1f}GFLOP/s|{t0 / t1:.2f}x"))
    want = flash_attention_plain(q, k, v)
    out["chunked_rel_err"] = _rel(chunked_attention(q, k, v, pos, pos,
                                                    kv_chunk=512), want)
    out["naive_s"], out["chunked_s"] = t0, t1
    if on_card:
        t2 = bc.timeit(lambda: flash_attention(q, k, v), device=dev)
        out["kernel_s"] = t2
        out["kernel_rel_err"] = _rel(flash_attention(q, k, v), want)
        rows.append(bc.row("kernels/attention-flash-kernel/cuda", t2 * 1e6,
                           f"{flops / t2 / 1e9:.1f}GFLOP/s|{t0 / t2:.2f}x|"
                           f"rel err {out['kernel_rel_err']:.1e}"))
    return {"rows": rows, **out}


def bench_ssd(dev, on_card: bool) -> dict:
    from repro_torch.kernels.ssd.ops import ssd_chunked_kernel
    from repro_torch.models.ssm import ssd_chunked, ssd_reference
    bs, s, h, p, grp, n, chunk = (SSD[k] for k in
                                  ("b", "s", "h", "p", "g", "n", "chunk"))
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(bs, s, h, p)
    dt = torch.nn.functional.softplus(randn(bs, s, h))
    a = -torch.exp(randn(h) * 0.3)
    b, c = randn(bs, s, grp, n) * 0.3, randn(bs, s, grp, n) * 0.3
    dsk = torch.ones(h, device=dev)
    args = (x, dt, a, b, c, dsk)
    rows, out = [], {}
    t0 = bc.timeit(lambda: ssd_reference(*args), device=dev)
    t1 = bc.timeit(lambda: ssd_chunked(*args, chunk), device=dev)
    rows.append(bc.row("kernels/ssd-recurrence", t0 * 1e6, "1.00x"))
    rows.append(bc.row("kernels/ssd-chunked", t1 * 1e6, f"{t0 / t1:.2f}x"))
    want = ssd_reference(*args)
    out["chunked_rel_err"] = _rel(ssd_chunked(*args, chunk), want)
    out["recurrence_s"], out["chunked_s"] = t0, t1
    if on_card:
        t2 = bc.timeit(lambda: ssd_chunked_kernel(*args, chunk), device=dev)
        out["kernel_s"] = t2
        out["kernel_rel_err"] = _rel(ssd_chunked_kernel(*args, chunk), want)
        rows.append(bc.row("kernels/ssd-chunked-kernel/cuda", t2 * 1e6,
                           f"{t0 / t2:.2f}x|rel err "
                           f"{out['kernel_rel_err']:.1e}"))
    return {"rows": rows, **out}


def run(device="cuda", cells: int | None = None) -> dict:
    """Every row, the NEP rows at ``cells`` unit cells a side (default:
    ``CARD_CELLS`` on the card, 4 on the CPU or under the smoke switch)."""
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if cells is None:
        cells = CARD_CELLS if on_card and not bc.smoke() else 4
    reset_counters()
    out = {"device": str(dev)}
    with torch.no_grad():
        out["nep"] = bench_nep(dev, cells, on_card)
        out["attention"] = bench_attention(dev, on_card)
        out["ssd"] = bench_ssd(dev, on_card)
    out["launches"] = read_counters()
    out["rows"] = [r for k in ("nep", "attention", "ssd")
                   for r in out[k].pop("rows")]
    errs = {"nep." + k: v for k, v in out["nep"]["parity"].items()}
    for k in ("attention", "ssd"):
        errs.update({f"{k}.{e}": out[k][e] for e in out[k]
                     if e.endswith("rel_err")})
    bad = {k: v for k, v in errs.items() if not v < REL_BAR}
    if bad:
        raise AssertionError(f"kernel rows disagree with their plain "
                             f"counterparts beyond {REL_BAR}: {bad}")
    if on_card:
        idle = [k for k, v in out["launches"].items() if v["total"] == 0]
        if idle:
            raise AssertionError(f"kernel rows launched no {idle}")
    return out


def main(argv=None) -> dict:
    ap = bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    ap.add_argument("--cells", type=int, default=None,
                    help="B20 unit cells a side of the NEP rows")
    args = bc.parse(ap, argv)
    with bc.switches(args):
        out = run(args.device, args.cells)
    bc.write_json(args.out / "kernel_rows.json", out)
    return out


if __name__ == "__main__":
    main()
