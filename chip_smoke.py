#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits nonzero, printing
no result, without them.  Phases (each raises on failure):

1. the card's name and power limit; build every kernel from ``csrc/``;
   ptxas's registers, stack frame and spills of each kernel body;
2. each kernel against its plain PyTorch version on B20 8x8x8 (4,096 atoms,
   0.08 A thermal jitter, random spins, production spec, capacity 64): f64
   within 1e-9 and f32 within 1e-4 of each output's max |ref|, K1 and K2
   each in both bodies (warp per atom, the default at this spec, and thread
   per atom); and ``nep_compute`` through the kernels against the autograd
   ``compute``;
3. the main path: ``Engine`` with ``NEPSpinPotential(use_kernel=True)`` on
   32x32x32 B20 cells (262,144 atoms) for 3 chunks x 20 steps at 300 K in a
   0.2 T field; launch counts must equal 1 + steps + rebuilds (one
   evaluation at construction, one per step, one per rebuild), every K1 and
   K2 launch in the warp-per-atom body;
4. each kernel (K1 and K2 in both bodies) against its plain version at the
   main path's shapes (f32, 1e-4), and times of each with CUDA events (the
   bodies in turns: warp, thread, thread, warp), beside the least time the
   card could take (bytes at 3.35 TB/s or f32 operations at 67 TFLOP/s);
5. SSD and FA against their plain versions on the sweeps of
   ``tests/test_kernels_ssd.py`` and ``tests/test_kernels_attention.py``,
   SSD at Mamba-2-2.7B's chunk (L=128, P=64, N=128: the CUDA-core body's
   other shared-memory layout), SSD in both bodies (tensor cores, the bf16
   default, and CUDA cores) on bf16 copies of the f32 sweep cases plus the
   bf16 one (N = 128 among them), and FA's tensor-core body on bf16 copies
   of the f32 sweep cases plus d = 80 and dv = 24 cases (its exact and
   guarded instantiations: window, ragged S and T, GQA, dv != d,
   dv % 16 = 8): f32 within 1e-4 of max |ref|; bf16 inputs within 5e-4 for
   SSD (its outputs are f32 on both sides) and 2e-2 for FA (its output is
   rounded to bf16; bf16 runs FA's tensor-core body, f32 its CUDA-core
   body);
6. Zamba2-2.7B at full width and depth (54 layers, d_model 2560, random
   weights from a seed) in f32 with TF32 off: forward logits of B=2 x
   S=256 tokens (two SSD chunks) against 256 decode steps from empty
   caches, within 5e-3 of max |logit|;
7. the LM main path, bf16: ``make_prefill_fn`` at B=2, S=8,192 (the
   ``prefill_32k`` shape cut to one card), one warm call and the median of
   3 in prefill tokens/s; every call must launch SSD 54 times, all in its
   tensor-core body, and FA 9 times (bf16, so FA's tensor-core body;
   counts set to 0 before each call), and give finite logits;
8. ``make_decode_fn`` at B=8 against 8,192-slot caches, 64 greedy steps
   after 2 warm ones, in decode tokens/s; decode runs no kernel, so the
   counts must stay 0;
9. SSD and FA at the prefill's shapes against their plain versions, in
   f32 (1e-4) and in bf16 (SSD 5e-4, both bodies; FA 5e-3, about one bf16
   ulp of its largest output), and FA's bf16 output row by row against the
   f32 plain
   version on the same (bf16-valued) inputs: each output's error beyond
   half a bf16 ulp (its own rounding), over its row's max |ref|, within
   1e-4 (P V with P's bf16 hi half alone reads ~3e-3 there); timed in bf16
   beside the plain versions (SSD's bodies in turns: tc, cuda_core,
   cuda_core, tc) and, for FA, the library call
   ``scaled_dot_product_attention`` (a yardstick the port never calls),
   and the least time the card could take (bytes at 3.35 TB/s or
   contraction flops at the bf16 dense peak of 989 TFLOP/s);
A. field cooling at the main path's size: ``Engine`` with K1/K2 under
   ``protocol.field_cooling(300, 100, 0.2, t_hold=0.02, t_ramp=0.04)``,
   4 chunks x 20 steps, all six observables every 5 steps, a runlog with
   ``HealthConfig(max_spin_dev=1e-3)``, a profiler trace and a checkpoint
   every chunk (keep 2, the chunk-2 step pinned), under ``build/``; run
   once bare and once with all of that: every step's temperature equals
   the protocol's formula written out in numpy and its field 0.2 T along
   z, every K1/K2 launch is in the warp body (1 + steps + rebuilds), the
   runlog parses with 0 compiles after the first chunk and every verdict
   "ok", the profiled run wrote a non-empty Chrome trace, and the runs
   end bitwise equal; steps/s of each, and a checkpoint's size, save time
   (and the call time of ``save_md``'s async write) at this size;
B. the chunk-2 checkpoint restored into a fresh Engine and run through
   chunks 3-4: ``torch.equal`` with phase A's final pos, vel, spin, step,
   rebuild count and trace rows; the restore time;
C. Heisenberg-DMI on the same 262,144-atom B20 lattice (Morse minimum at
   the Fe-Fe distance), 2 chunks x 20 steps, midpoint with 2 iterations,
   300 K: steps/s and peak memory; a resume from the chunk-1 checkpoint
   bitwise equal; the deterministic pair-reaction and spin-grid sums
   against ``index_add_`` on the same inputs (f32 within 2e-5 of max
   |ref|; two deterministic evaluations equal), and both timed;
   one ``{"md_surface": ...}`` line with phases A-C's numbers;
D. the md_loop scenario (``launch/md_loop.py``: simple cubic 16^3 = 4,096
   atoms, chunk 20, skin 0.2, capacity 8, 500 K): Heisenberg-DMI fused
   against legacy (400 steps), autograd NEP-SPIN fused against legacy (60),
   the K1/K2 path (20) against the autograd fused path, and telemetry
   runs against bare ones in turns, with the scenario's gates (>= 3
   rebuilds per fused run, 1 on the
   kernel path; no kernel build or load while timed; telemetry overhead
   under 25 %); every K1 and K2 launch of the kernel path in the warp
   body; then K1 and K2, both bodies, on the kernel path's own table,
   blocks and spins after its timed run against the plain versions (f32
   1e-4; f64 1e-9 on the same inputs cast); one ``{"md_loop": ...}`` line
   with those errors;
E. the Replicated plan at full width: 4 copies of the main path's lattice
   (4 x 262,144 atoms, each replica's velocities and a 0.02 A position
   jitter from its own generator) under phase A's field cooling, 3 x 20
   steps: K1 and K2 launches equal 1 + steps + rebuilds (one launch per
   evaluation for all replicas), all warp; (b) K1 and K2 on an R = 4
   batch of B20 8x8x8, both bodies, against the plain versions (f64 1e-9,
   f32 1e-4) and each replica bitwise a flat launch; (c) a 10-step chunk
   of the batch bitwise 4 flat Engines on its table with the same
   generators; (d) checkpoints every chunk leave the run bitwise as it
   was, and a resume from the chunk-1 checkpoint is bitwise the
   uninterrupted run; (e) per-slot mode on a frozen lattice:
   ``write_slots`` into slot 2 between chunks leaves slots 0, 1 and 3
   bitwise unchanged; replica-steps/s, atom-steps/s, peak memory, and K1
   and K2 per batched launch beside 4 flat launches (in turns); one
   ``{"replica_plan": ...}`` line;
F. the ensemble layer: ``launch/skyrmion_nucleation.py`` at
   ``nucleation_ensemble()`` (8 x 32x32x1 films, Heisenberg-DMI, thermal
   and cold; depth cut to ``NUCLEATION_STEPS``), parallel tempering on
   four of its films, a 4-rung ladder over its protocol's 20-95 K, a swap
   attempt every 10 steps for ``TEMPERING_CHUNKS`` chunks (accepts > 0),
   ``run_sweep`` on
   ``nucleation_ensemble_smoke()``'s grid, and ``launch/ensemble_rate.py``
   at R = 1, 4 and 16; one ``{"ensemble": ...}`` line;
10. the card's name and power limit, one ``{"kernels": [...]}`` line with
    all four kernels (K1, K2 and SSD with ``body`` and ``previous_ms``, the
    earlier body's time in this run; FA's ``previous_ms`` null, as its
    earlier body is gone; all with ptxas's report of the body timed; K1
    and K2 with ``launches_field_cooling`` from phase A, and from phase E
    ``launches_replica``, ``replica_ms`` and ``replica_flat_ms`` (one
    batched launch at R = 4, and 4 flat launches)), then
    ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # H100 SXM, bf16 dense tensor cores
KERNELS = {
    "nep_atom_pass": dict(
        source="src/repro_torch/kernels/nep/csrc/nep_atom_pass.cu",
        replaces="src/repro/kernels/nep/kernel.py:194"),
    "nep_force_pass": dict(
        source="src/repro_torch/kernels/nep/csrc/nep_force_pass.cu",
        replaces="src/repro/kernels/nep/kernel.py:379"),
    "ssd_chunks": dict(
        source="src/repro_torch/kernels/ssd/csrc/ssd_chunks.cu",
        replaces="src/repro/kernels/ssd/kernel.py:62"),
    "flash_attention_fwd": dict(
        source="src/repro_torch/kernels/attention/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/attention/kernel.py:68"),
}
# the sweeps of tests/test_kernels_ssd.py:10 and tests/test_kernels_attention.py:9
SSD_SWEEP = [   # bs, s, h, p, g, n, chunk, dtype
    (2, 64, 4, 8, 2, 16, 16, "float32"),
    (1, 48, 2, 16, 1, 8, 16, "float32"),
    (1, 128, 8, 8, 1, 32, 32, "float32"),
    (2, 64, 4, 8, 4, 16, 16, "float32"),
    (1, 64, 4, 8, 2, 16, 16, "bfloat16"),
    # Mamba-2-2.7B's chunk: N = 128 sends the CUDA-core body down its
    # unpadded shared-memory layout (230,400 of 232,448 bytes)
    (1, 256, 8, 64, 1, 128, 128, "float32"),
]
# bf16 copies of the f32 cases (N = 128: the tensor-core body's second
# exact instantiation; N = 8 and P = 16, 8: its guarded one)
SSD_SWEEP += [c[:7] + ("bfloat16",) for c in SSD_SWEEP if c[7] == "float32"]
FA_SWEEP = [    # b, s, t, h, hkv, d, dv, causal, window, dtype
    (2, 64, 64, 4, 2, 32, 32, True, 0, "float32"),
    (1, 48, 80, 4, 4, 16, 16, True, 16, "float32"),
    (2, 32, 64, 2, 1, 32, 32, False, 0, "float32"),
    (1, 40, 40, 8, 2, 64, 64, True, 0, "float32"),
    (1, 64, 64, 4, 1, 32, 16, True, 0, "float32"),
    (2, 64, 64, 4, 2, 32, 32, True, 0, "bfloat16"),
]
# FA's tensor-core body on the f32 cases in bf16 (its guarded
# instantiation), and its exact d = dv = 80 one with a window, ragged
# S < T and GQA, and dv % 16 = 8 (V's zeroed pad columns)
FA_TC_SWEEP = [c[:9] + ("bfloat16",) for c in FA_SWEEP[:5]] + [
    (1, 100, 130, 4, 2, 80, 80, True, 40, "bfloat16"),
    (2, 70, 70, 4, 4, 32, 24, True, 0, "bfloat16"),
]
# of max |ref|.  SSD's outputs are f32 on both sides, so bf16 inputs change
# nothing but the inputs; FA rounds its output to bf16 (the sweep keeps the
# reference suite's 2e-2; at the main shapes 5e-3 is about one bf16 ulp of
# the largest output)
SSD_BAR = {"float32": 1e-4, "bfloat16": 5e-4}
FA_BAR = {"float32": 1e-4, "bfloat16": 2e-2}
FA_MAIN_BF16_BAR = 5e-3
# FA bf16 at the prefill's shapes, row by row: error beyond the output's
# own rounding, over the row's max |ref| (see fa_beyond_rounding)
FA_MAIN_ROW_BAR = 1e-4
LM_ARCH = "zamba2-2.7b"
PREFILL_B, PREFILL_S = 2, 8192       # prefill_32k cut to one card
DECODE_B, DECODE_T, DECODE_STEPS = 8, 8192, 64
PARITY_B, PARITY_S = 2, 256          # two SSD chunks


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


def ptxas_report(text: str) -> dict:
    """``{mangled kernel: {registers, stack_bytes, spill_bytes}}`` from an
    ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def ptxas_of(reports: dict, library: str, *parts) -> dict:
    """The report of the one kernel of ``library`` whose mangled name holds
    every one of ``parts``."""
    hits = [v for k, v in reports[library].items()
            if all(p in k for p in parts)]
    if len(hits) != 1:
        raise AssertionError(f"ptxas report of {library}: {len(hits)} "
                             f"kernels match {parts}")
    return hits[0]


# the timed bodies' kernels in ptxas's reports (mangled names): the warp
# bodies' flat instantiation (BATCH false) at the production spec, f32
PROD_SIZES = "SizesILi2ELi8ELi6ELi4ELi4ELi4ELi32ELi3EEEfLb0EE"
PTXAS_K1_WARP = ("nep_atom_pass", "atom_pass_warp_kernel", PROD_SIZES)
PTXAS_K1_THREAD = ("nep_atom_pass", "atom_pass_kernelIfE")
PTXAS_K2_WARP = ("nep_force_pass", "force_pass_warp_kernel", PROD_SIZES)
PTXAS_K2_THREAD = ("nep_force_pass", "force_pass_kernelIfE")
PTXAS_SSD_TC = ("ssd_chunks", "ssd_chunk_tc_kernelILi4ELi8ELb1E")
PTXAS_SSD_CC = ("ssd_chunks", "ssd_chunk_kernelI13__nv_bfloat16E")
PTXAS_FA_TC = ("flash_attention_fwd", "flash_fwd_tc_kernelILi5ELi5ELb1E")


# ---------------------------------------------------------------------------
# LM serving path: Zamba2-2.7B through the SSD and flash-attention kernels
# ---------------------------------------------------------------------------

def lm_counters():
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    return ssd.ssd_chunks, fa.flash_attention_fwd


def reset_lm_counters():
    for fn in lm_counters():
        fn.launches = 0
    ssd = lm_counters()[0]
    ssd.body_launches = dict.fromkeys(ssd.body_launches, 0)


def read_lm_counters():
    return tuple(fn.launches for fn in lm_counters())


def lm_sweeps(torch, dev):
    """Phase 5: each LM kernel against its plain version on the sweeps of
    the reference's kernel tests.  Returns the worst error per dtype."""
    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    gen = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    worst = {"ssd_chunks": {}, "flash_attention_fwd": {}}
    for i, (bs, s, h, p, g, n, chunk, dtype) in enumerate(SSD_SWEEP):
        dt_ = getattr(torch, dtype)
        x = rnd(bs, s, h, p).to(dt_)
        dtv = torch.nn.functional.softplus(rnd(bs, s, h))
        a = -torch.exp(rnd(h) * 0.5)
        b = (rnd(bs, s, g, n) * 0.3).to(dt_)
        c = (rnd(bs, s, g, n) * 0.3).to(dt_)
        body = ssd.ssd_body(x, b, c, chunk)
        if body != {"float32": "cuda_core", "bfloat16": "tc"}[dtype]:
            raise AssertionError(f"SSD sweep {i} {dtype} chose {body}")
        want = ssd.ssd_chunks_plain(x, dtv, a, b, c, chunk=chunk)
        # bf16 runs both bodies; the default's error is the one kept
        for bd in ssd.BODIES if body == "tc" else (body,):
            got = ssd.ssd_chunks(x, dtv, a, b, c, chunk=chunk, body=bd)
            torch.cuda.synchronize()
            err = max(check(f"SSD sweep {i} {bd} {o} {dtype}", u, w,
                            SSD_BAR[dtype])
                      for o, u, w in zip(("y_intra", "states", "cum"), got,
                                         want))
            if bd == body:
                w = worst["ssd_chunks"]
                w[dtype] = max(w.get(dtype, 0.0), err)
    cases = [("sweep", i, c) for i, c in enumerate(FA_SWEEP)] + [
        ("tensor-core sweep", i, c) for i, c in enumerate(FA_TC_SWEEP)]
    for label, i, (b, s, t, h, hkv, d, dv, causal, win, dtype) in cases:
        dt_ = getattr(torch, dtype)
        q, k, v = (rnd(b, s, h, d).to(dt_), rnd(b, t, hkv, d).to(dt_),
                   rnd(b, t, hkv, dv).to(dt_))
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=win)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = check(f"FA {label} {i} {dtype}", got.float(), want.float(),
                    FA_BAR[dtype])
        w = worst["flash_attention_fwd"]
        w[dtype] = max(w.get(dtype, 0.0), err)
    return worst


def lm_parity(torch, dev, cfg):
    """Phase 6: full-width f32 forward logits against token-by-token decode
    from empty caches (the forward path runs both kernels, decode none)."""
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    params = lm.init_params(cfg32, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (PARITY_B, PARITY_S), generator=gen,
                           device=dev)
    t0 = time.perf_counter()
    h, logits_fn = tfm.forward(cfg32, params, tokens)
    full = logits_fn(h).float()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("f32 forward logits are not finite")
    caches = tfm.init_caches(cfg32, PARITY_B, PARITY_S, torch.float32, dev)
    decode = lm.make_decode_fn(cfg32)
    err = torch.zeros((), device=dev)
    t0 = time.perf_counter()
    for i in range(PARITY_S):
        pos = torch.full((PARITY_B,), i, dtype=torch.int32, device=dev)
        logits, caches = decode(params, caches,
                                {"token": tokens[:, i:i + 1], "position": pos})
        err = torch.maximum(err, (logits - full[:, i]).abs().max())
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    rel = float(err) / float(full.abs().max())
    log(f"  f32 forward {fwd_s:.2f} s, {PARITY_S} decode steps {dec_s:.2f} s;"
        f" max |decode - forward| / max |forward| = {rel:.3e} (bar 5e-3)")
    if not rel < 5e-3:
        raise AssertionError(f"decode vs prefill relative error {rel:.3e}")
    return rel


def lm_prefill(torch, dev, cfg, params):
    """Phase 7: timed bf16 prefill; every call must launch SSD once per
    Mamba-2 block and FA once per shared-block invocation."""
    from repro_torch.models import lm
    from repro_torch.models.transformer import padded_vocab
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev)
    prefill = lm.make_prefill_fn(cfg)
    expect = (cfg.n_layers, cfg.n_layers // cfg.shared_every)
    secs, counts = [], None
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(4):
        torch.cuda.synchronize()
        reset_lm_counters()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = read_lm_counters()
        if counts != expect:
            raise AssertionError(f"prefill call {i} launched (SSD, FA) = "
                                 f"{counts}, expected {expect}")
        ssd_bodies = lm_counters()[0].body_launches
        if ssd_bodies != {"tc": expect[0], "cuda_core": 0}:
            raise AssertionError(f"prefill call {i}: SSD launches by body "
                                 f"{ssd_bodies}, all must be tensor-core")
    if tuple(logits.shape) != (PREFILL_B, padded_vocab(cfg.vocab)) or not \
            bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    med = sorted(secs[1:])[1]
    tps = PREFILL_B * PREFILL_S / med
    log(f"  prefill B={PREFILL_B} S={PREFILL_S}: warm {secs[0]:.3f} s, "
        f"calls {[round(s, 4) for s in secs[1:]]} s, median {med:.4f} s = "
        f"{tps:.1f} prefill tokens/s; launches in the last call (SSD, FA) "
        f"= {counts}, SSD by body {lm_counters()[0].body_launches}; peak "
        f"memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return {"tokens_per_s": tps, "median_s": med, "launches": counts}


def lm_decode(torch, dev, cfg, params):
    """Phase 8: timed bf16 greedy decode against caches of DECODE_T slots;
    decode runs no kernel, so the counters must not move."""
    from repro_torch.models import lm
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=dev).manual_seed(3)
    caches = tfm.init_caches(cfg, DECODE_B, DECODE_T, torch.bfloat16, dev)
    decode = lm.make_decode_fn(cfg)
    tok = torch.randint(0, cfg.vocab, (DECODE_B, 1), generator=gen,
                        device=dev)
    reset_lm_counters()

    def step(i, tok):
        pos = torch.full((DECODE_B,), i, dtype=torch.int32, device=dev)
        logits, _ = decode(params, caches, {"token": tok, "position": pos})
        return logits, logits.argmax(-1, keepdim=True)

    for i in range(2):                       # warm
        logits, tok = step(i, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, 2 + DECODE_STEPS):
        logits, tok = step(i, tok)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if read_lm_counters() != (0, 0):
        raise AssertionError(f"decode launched (SSD, FA) = "
                             f"{read_lm_counters()}, expected none")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not finite")
    tps = DECODE_B * DECODE_STEPS / secs
    log(f"  decode B={DECODE_B} against {DECODE_T}-slot caches: "
        f"{DECODE_STEPS} steps in {secs:.3f} s = {1e3 * secs / DECODE_STEPS:.2f}"
        f" ms/step = {tps:.1f} decode tokens/s; no kernel launched")
    return {"tokens_per_s": tps, "ms_per_step": 1e3 * secs / DECODE_STEPS}


def ssd_names(tag):
    return [f"SSD main {o} {tag}" for o in ("y_intra", "states", "cum")]


def compare_main(torch, names, kernel, plain, args, bar, **kw):
    """One kernel against its plain version on ``args``, one name per
    output; returns the worst relative and absolute errors."""
    got, want = kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    rel = max(check(name, u.float(), w.float(), bar)
              for name, u, w in zip(names, got, want))
    return rel, max(float((u.float() - w.float()).abs().max())
                    for u, w in zip(got, want))


def lm_kernels_main(torch, dev, cfg, sweep_err, launches, ptxas):
    """Phase 9: each LM kernel at the prefill's shapes, against its plain
    version in f32 and in bf16 (the config's dtype); timed in bf16 beside
    the plain version, the library call where one exists, and the least
    time the card could take."""
    import math

    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.models.ssm import ssm_dims
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16 = torch.bfloat16
    B, S = PREFILL_B, PREFILL_S
    rows = []

    # SSD: x, B and C as the strided views of the conv output
    s = cfg.ssm
    d_in, H = ssm_dims(cfg)
    G, N, P, L = s.n_groups, s.d_state, s.head_dim, s.chunk
    xbc = torch.randn((B, S, d_in + 2 * G * N), generator=gen, device=dev,
                      dtype=bf16)
    x = xbc[..., :d_in].view(B, S, H, P)
    b = xbc[..., d_in:d_in + G * N].view(B, S, G, N)
    c = xbc[..., d_in + G * N:].view(B, S, G, N)
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev))
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    args = (x, dt, a, b, c)
    xbc32 = xbc.float()
    args32 = (xbc32[..., :d_in].view(B, S, H, P), dt, a,
              xbc32[..., d_in:d_in + G * N].view(B, S, G, N),
              xbc32[..., d_in + G * N:].view(B, S, G, N))
    rel32, _ = compare_main(torch, ssd_names("f32"),
                            ssd.ssd_chunks, ssd.ssd_chunks_plain, args32,
                            SSD_BAR["float32"], chunk=L)
    del xbc32, args32
    if ssd.ssd_body(x, b, c, L) != "tc":
        raise AssertionError("SSD at the prefill's shapes must take the "
                             "tensor-core body")
    rel, abs_err = compare_main(torch, ssd_names("bf16 tc"),
                                ssd.ssd_chunks, ssd.ssd_chunks_plain, args,
                                SSD_BAR["bfloat16"], chunk=L)
    compare_main(
        torch, ssd_names("bf16 cuda_core"),
        functools.partial(ssd.ssd_chunks, body="cuda_core"),
        ssd.ssd_chunks_plain, args, SSD_BAR["bfloat16"], chunk=L)
    nc = S // L
    f32_out = 4 * B * nc * (L * H * P + H * N * P + L * H)
    nbytes_ssd = nbytes(x, b, c, dt, a) + f32_out
    tri = L * (L + 1) // 2
    flops_ssd = 2.0 * B * nc * H * (tri * N + tri * P + L * N * P)
    # the bodies in turns: tc, cuda_core, cuda_core, tc
    ssd_ms = {"tc": [], "cuda_core": []}
    for body in ("tc", "cuda_core", "cuda_core", "tc"):
        ssd_ms[body].append(time_ms(torch, lambda: ssd.ssd_chunks(
            *args, chunk=L, body=body), 20))
    log(f"  SSD by body, in turns (ms): {ssd_ms}")
    plain = time_ms(torch, lambda: ssd.ssd_chunks_plain(*args, chunk=L), 2)
    rows.append(kernel_row(
        "ssd_chunks", launches[0], abs_err, sum(ssd_ms["tc"]) / 2, plain,
        None, nbytes_ssd, flops_ssd,
        {"max_rel_err_f32": max(rel32, sweep_err["ssd_chunks"]["float32"]),
         "max_rel_err_bf16": max(rel, sweep_err["ssd_chunks"]["bfloat16"]),
         "body": "tc",
         "previous_ms": sum(ssd_ms["cuda_core"]) / 2,
         "previous_body": "cuda_core",
         "ptxas": ptxas_of(ptxas, *PTXAS_SSD_TC),
         "previous_ptxas": ptxas_of(ptxas, *PTXAS_SSD_CC)}))
    del xbc, x, b, c, dt, args
    torch.cuda.empty_cache()

    # FA: the shared block's causal GQA prefill attention
    Hq, Hkv, d = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = torch.randn((B, S, Hq, d), generator=gen, device=dev, dtype=bf16)
    k = torch.randn((B, S, Hkv, d), generator=gen, device=dev, dtype=bf16)
    v = torch.randn((B, S, Hkv, d), generator=gen, device=dev, dtype=bf16)
    errs = fa_prefill_errors(torch, q, k, v)
    for name, key, bar in (("FA main f32", "f32", FA_BAR["float32"]),
                           ("FA main bf16", "bf16", FA_MAIN_BF16_BAR),
                           ("FA main bf16 by row", "bf16_row",
                            FA_MAIN_ROW_BAR)):
        log(f"  {name:<28} rel err {errs[key]:.3e} (bar {bar:g})")
        if not errs[key] < bar:
            raise AssertionError(f"{name}: relative error {errs[key]:.3e} "
                                 f">= {bar:g}")
    torch.cuda.empty_cache()
    nbytes_fa = nbytes(q, k, v) + B * S * Hq * d * q.element_size()
    flops_fa = 2.0 * B * Hq * (S * (S + 1) // 2) * (d + d)
    ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                 10)
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                            causal=True), 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=1 / math.sqrt(d)), 20)
    rows.append(kernel_row(
        "flash_attention_fwd", launches[1], errs["bf16_abs"], ms, plain, lib,
        nbytes_fa, flops_fa,
        {"max_rel_err_f32": max(
            errs["f32"], sweep_err["flash_attention_fwd"]["float32"]),
         "max_rel_err_bf16": max(
             errs["bf16"], sweep_err["flash_attention_fwd"]["bfloat16"]),
         "max_row_err_bf16": errs["bf16_row"], "previous_ms": None,
         "ptxas": ptxas_of(ptxas, *PTXAS_FA_TC)}))
    return rows


def fa_beyond_rounding(torch, got, want) -> float:
    """Each bf16 output's error against the f32 ``want`` beyond half a
    bf16 ulp of the larger of the two magnitudes (what rounding the output
    alone may add), floored at 0, over the max |want| of its row (the last
    dimension); the largest over all rows.  Rounding P to bf16 once shows
    here, where one-ulp flips of the output hide it from the max-|ref|
    measure."""
    got = got.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    half_ulp = torch.exp2((e - 9).float())   # magnitude in [2^(e-1), 2^e)
    excess = ((got - want).abs() - half_ulp).clamp_min(0).amax(-1)
    return float((excess / want.abs().amax(-1).clamp_min(1e-30)).max())


def fa_prefill_errors(torch, q, k, v) -> dict:
    """FA on bf16 q, k, v at the prefill's shapes against its plain
    version: ``f32``, the f32 kernel on the same values, relative to max
    |ref|; ``bf16`` and ``bf16_abs``, the bf16 kernel against the bf16
    plain version; ``bf16_row``, :func:`fa_beyond_rounding` of the bf16
    kernel against the f32 plain version."""
    from repro_torch.kernels.attention import kernel as fa
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want32 = fa.flash_attention_plain(q32, k32, v32, causal=True)
    got32 = fa.flash_attention_fwd(q32, k32, v32, causal=True)
    del q32, k32, v32
    got = fa.flash_attention_fwd(q, k, v, causal=True)
    want = fa.flash_attention_plain(q, k, v, causal=True).float()
    torch.cuda.synchronize()
    out = {"f32": rel_err(got32, want32),
           "bf16": rel_err(got.float(), want),
           "bf16_abs": float((got.float() - want).abs().max()),
           "bf16_row": fa_beyond_rounding(torch, got, want32)}
    del got32, want32, got, want
    return out


def kernel_row(name, launches, abs_err, ms, plain_ms, library_ms, nbytes_,
               flops, extra):
    """One row of the kernels line for a bf16 LM kernel: the bound is the
    larger of its bytes at 3.35 TB/s and its contraction flops at the bf16
    dense tensor-core peak of 989 TFLOP/s."""
    t_bytes = 1e3 * nbytes_ / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / BF16_FLOPS_PER_S
    bound = max(t_bytes, t_ops)
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    log(f"  {name}: {ms:.3f} ms (plain {plain_ms:.1f} ms, library {lib}); "
        f"{nbytes_ / 1e6:.1f} MB -> {t_bytes:.4f} ms, {flops / 1e9:.2f} "
        f"GFLOP -> {t_ops:.4f} ms at bf16 peak; bound {bound:.4f} ms = "
        f"{100 * bound / ms:.2f}% of the kernel's time")
    meta = KERNELS[name]
    return {"name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches,
            "max_abs_err": abs_err, **extra, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_peak": "3.35 TB/s; bf16 dense 989 TFLOP/s",
            "library_ms": library_ms}


def lm_phases(torch, dev, ptxas):
    """Phases 5-9 (the LM serving path); returns their kernel rows."""
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get(LM_ARCH)
    log(f"phase 5: SSD and FA against their plain versions on the "
        f"reference's sweeps")
    sweep_err = lm_sweeps(torch, dev)
    log(f"phase 6: {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}) in f32: decode vs prefill, B={PARITY_B}, "
        f"S={PARITY_S}")
    lm_parity(torch, dev, cfg)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"phase 7: {cfg.name} bf16 prefill ({n_par / 1e9:.3f} B parameters, "
        f"{sum(nbytes(t) for t in _leaves(params)) / 1e9:.2f} GB)")
    pre = lm_prefill(torch, dev, cfg, params)
    log("phase 8: bf16 decode")
    lm_decode(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    log("phase 9: SSD and FA at the prefill's shapes (f32 and bf16)")
    return lm_kernels_main(torch, dev, cfg, sweep_err, pre["launches"],
                           ptxas)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# the full single-device MD surface: field cooling with telemetry and
# checkpoints, bitwise resume, Heisenberg-DMI
# ---------------------------------------------------------------------------

SURFACE_DIR = ROOT / "build" / "chip_smoke"
FC_CHUNKS, FC_CHUNK, FC_OBS_EVERY = 4, 20, 5
FC_OBS = ("energy", "kinetic", "magnetization", "charge", "skyrmion_count",
          "pitch")
# the Fig. 9 protocol: 300 K for 20 fs, down to 100 K over 40 fs, 0.2 T
FC_T = dict(t_hot=300.0, t_cold=100.0, b_field=0.2, t_hold=0.02,
            t_ramp=0.04)
# Heisenberg-DMI on the B20 lattice: its Morse minimum at the Fe-Fe
# nearest-neighbor distance (the default r0 is the lattice constant, which
# would push the 2.4-2.9 A B20 neighbors apart at ~150 eV/A)
HEIS_B20 = dict(r0=2.9, morse_de=0.05, d0=0.008, ka=0.001)
HEIS_CHUNKS, HEIS_CHUNK = 2, 20


def reset_md_counters(kern):
    for fn in (kern.nep_atom_pass, kern.nep_force_pass):
        fn.launches = 0
        fn.body_launches = dict.fromkeys(kern.BODIES, 0)


def read_md_counters(kern):
    return {fn.__name__: (fn.launches, dict(fn.body_launches))
            for fn in (kern.nep_atom_pass, kern.nep_force_pass)}


def cooling_rows(dt: float):
    """The per-step temperatures of the field-cooling protocol, written out
    here in numpy float32 (hold, linear ramp, hold) at the engine's clock:
    chunk start ``step * dt`` plus ``i * dt``, both float32."""
    import numpy as np
    f32 = np.float32
    t = np.concatenate([f32(c * FC_CHUNK) * f32(dt)
                        + np.arange(FC_CHUNK, dtype=f32) * f32(dt)
                        for c in range(FC_CHUNKS)])
    t0 = f32(FC_T["t_hold"])
    t1 = f32(FC_T["t_hold"] + FC_T["t_ramp"])
    hot, cold = f32(FC_T["t_hot"]), f32(FC_T["t_cold"])
    w = np.clip((t - t0) / np.maximum(t1 - t0, f32(1e-30)), f32(0), f32(1))
    ramp = hot + w * (cold - hot)
    return np.where(t < t0, hot, np.where(t >= t1, cold, ramp))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def fc_engine(torch, dev, spec, lat, moments, kern):
    """A field-cooling Engine at the main path's size and spec, K1/K2."""
    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import init_state
    run = main_path()
    dtype = getattr(torch, run.dtype)
    state = init_state(lat, run.unit_cells, generator=torch.Generator(
        device=dev).manual_seed(21), temperature=FC_T["t_hot"], dtype=dtype,
        device=dev)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(22),
                         dtype=dtype, device=dev)
    temp, field = protocol.field_cooling(
        FC_T["t_hot"], FC_T["t_cold"], FC_T["b_field"],
        t_hold=FC_T["t_hold"], t_ramp=FC_T["t_ramp"])
    cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                           spin_alpha=run.spin_alpha)
    return run, Engine(
        NEPSpinPotential(spec, params, moments.to(dtype), use_kernel=True),
        cfg, state, torch.tensor(lat.masses, dtype=dtype, device=dev),
        torch.tensor(lat.moments, device=dev) > 0, spec.cutoff,
        temperature=temp, field=field, observables=FC_OBS,
        obs_every=FC_OBS_EVERY, capacity=run.capacity, skin=run.skin,
        use_cell_list=True, cell_capacity=run.cell_capacity, device=dev)


def same_run(torch, a, b, rows, what):
    """Raise unless engine ``b`` ended bitwise where ``a`` did and its
    trace equals ``a``'s rows ``rows``."""
    import numpy as np
    for k in ("pos", "vel", "spin"):
        if not torch.equal(getattr(a.state, k), getattr(b.state, k)):
            d = float((getattr(a.state, k) - getattr(b.state, k)).abs().max())
            raise AssertionError(f"{what}: {k} differs (max |diff| {d:.3e})")
    if (a.state.step, a.n_rebuilds) != (b.state.step, b.n_rebuilds):
        raise AssertionError(f"{what}: step / rebuilds {a.state.step}, "
                             f"{a.n_rebuilds} vs {b.state.step}, "
                             f"{b.n_rebuilds}")
    for k, v in b.trace.values.items():
        if not np.array_equal(a.trace.values[k][rows], v):
            raise AssertionError(f"{what}: trace {k} differs")


def phase_field_cooling(torch, dev, spec, lat, moments, kern) -> dict:
    """Phases A and B; returns their numbers."""
    import shutil

    import numpy as np

    from repro_torch.ckpt.checkpoint import save_md
    from repro_torch.telemetry import HealthConfig, Telemetry, read_runlog
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    ckpt = SURFACE_DIR / "ckpt"
    steps = FC_CHUNKS * FC_CHUNK
    log(f"phase A: field cooling (Fig. 9: {FC_T}) at the main path's size, "
        f"{FC_CHUNKS} x {FC_CHUNK} steps, observables {FC_OBS} every "
        f"{FC_OBS_EVERY} steps, runlog + health + profile + checkpoints")
    out, done = {}, {}
    # bare; with a runlog, health checks and a checkpoint every chunk; and
    # with a profiler trace on top (its runlog and checkpoints are the ones
    # checked and restored)
    for tag in ("bare", "telemetry", "profiled"):
        torch.cuda.synchronize()
        reset_md_counters(kern)
        run, eng = fc_engine(torch, dev, spec, lat, moments, kern)
        seen = []
        step = eng._step

        def recording(st, ff, nbh, gen, temp, field, _step=step):
            seen.append((temp, field))
            return _step(st, ff, nbh, gen, temp, field)

        eng._step = recording
        gen = torch.Generator(device=dev).manual_seed(23)
        kw = {}
        if tag != "bare":
            eng.ckpt_pin = 2 * FC_CHUNK       # phase B restores it
            sub = SURFACE_DIR / tag
            kw = dict(checkpoint_dir=str(sub / "ckpt"), checkpoint_keep=2,
                      telemetry=Telemetry(
                          runlog=sub / "field_cooling.jsonl",
                          health=HealthConfig(max_spin_dev=1e-3),
                          profile_dir=(sub / "profile" if tag == "profiled"
                                       else None)))
        # first uses (the FFT plan, sorts) outside the timed run
        eng._observe(eng._carry.state, eng._carry.ff)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(steps, gen, chunk=FC_CHUNK, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_md_counters(kern)
        expect = 1 + steps + eng.n_rebuilds
        log(f"  {tag}: {steps} steps in {secs:.3f} s = {steps / secs:.3f} "
            f"steps/s, rebuilds {eng.n_rebuilds}, launches {counts}")
        for name, (n, by_body) in counts.items():
            if n != expect or by_body != {"warp": expect, "thread": 0}:
                raise AssertionError(f"{name}: launches {n} by body "
                                     f"{by_body}, expected {expect}, all "
                                     "in the warp body")
        temps = np.asarray([t for t, _ in seen], np.float32)
        if not np.array_equal(temps, cooling_rows(run.dt)):
            raise AssertionError("per-step temperatures differ from the "
                                 "protocol's formula")
        fields = torch.stack([f for _, f in seen]).cpu()
        if not torch.equal(fields, torch.tensor(
                [[0.0, 0.0, FC_T["b_field"]]] * steps,
                dtype=fields.dtype)):
            raise AssertionError("per-step fields differ from 0.2 T along z")
        n_emit = steps // FC_OBS_EVERY
        for k, v in eng.trace.values.items():
            if v.shape[0] != n_emit or not np.isfinite(v).all():
                raise AssertionError(f"observable {k}: shape {v.shape} or "
                                     "non-finite values")
        out[tag] = dict(steps_per_s=steps / secs, seconds=secs,
                        rebuilds=eng.n_rebuilds, launches=expect)
        done[tag] = eng
        if tag == "bare":
            continue
        same_run(torch, done["bare"], eng, slice(None),
                 f"{tag}: telemetry and checkpoints changed the trajectory")
        events = read_runlog(SURFACE_DIR / tag / "field_cooling.jsonl")
        chunks = [e for e in events if e["event"] == "chunk"]
        kinds = [e["event"] for e in events]
        if kinds != ["run_start"] + ["chunk"] * FC_CHUNKS + ["run_end"]:
            raise AssertionError(f"runlog events {kinds}")
        if any(c["compiles"] for c in chunks[1:]):
            raise AssertionError(f"compiles after the first chunk: "
                                 f"{[c['compiles'] for c in chunks]}")
        if (any(c["verdict"] != "ok" for c in chunks)
                or events[-1]["status"] != "ok"):
            raise AssertionError(f"verdicts {[c['verdict'] for c in chunks]}"
                                 f", status {events[-1]['status']}")
        ckpts = sorted(p.name for p in (SURFACE_DIR / tag / "ckpt").iterdir())
        chunk_rates = [c["steps_per_s"] for c in chunks]
        log(f"  {tag} runlog: {len(events)} records, compiles "
            f"{[c['compiles'] for c in chunks]}, verdicts "
            f"{[c['verdict'] for c in chunks]}, in-chunk steps/s "
            f"{[round(r, 3) for r in chunk_rates]}, last health "
            f"{chunks[-1]['health']}; checkpoints {ckpts}")
        out[tag]["chunk_steps_per_s"] = chunk_rates
        if tag == "profiled":
            trace = SURFACE_DIR / tag / "profile" / "trace.json"
            if not trace.is_file() or trace.stat().st_size == 0:
                raise AssertionError(f"no profiler trace at {trace}")
            out[tag]["trace_bytes"] = trace.stat().st_size
            log(f"  provenance {events[0]['provenance']}; trace "
                f"{trace.stat().st_size / 1e6:.1f} MB")
            log(f"  observables at the last emission: "
                f"{ {k: v[-1].tolist() for k, v in eng.trace.values.items()} }")
    ckpt = SURFACE_DIR / "profiled" / "ckpt"

    # the cost of a checkpoint at this size, outside the run
    t0 = time.perf_counter()
    path = eng.save(str(SURFACE_DIR / "timing"), gen)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    handle = save_md(str(SURFACE_DIR / "timing_async"), eng.ckpt_step(),
                     eng._ckpt_tree(eng._carry), gen, async_=True)
    async_s = time.perf_counter() - t0
    handle.join()
    size = dir_bytes(Path(path))

    log("phase B: restore the chunk-2 checkpoint into a fresh Engine, run "
        "chunks 3-4, hold them bitwise to phase A")
    _, fresh = fc_engine(torch, dev, spec, lat, moments, kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen_b = fresh.restore(str(ckpt), step=2 * FC_CHUNK)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fresh.run(steps - 2 * FC_CHUNK, gen_b, chunk=FC_CHUNK)
    same_run(torch, eng, fresh, slice(steps // FC_OBS_EVERY // 2, None),
             "resume")
    log(f"  resumed run is bitwise phase A's (pos, vel, spin, step "
        f"{fresh.state.step}, rebuilds {fresh.n_rebuilds}, trace rows); "
        f"checkpoint {size / 1e6:.1f} MB, save {save_s:.3f} s (async call "
        f"returns in {async_s:.3f} s), load + re-derived blocks "
        f"{load_s:.3f} s")
    out.update(ckpt_bytes=size, save_s=save_s, async_call_s=async_s,
               load_s=load_s)
    del eng, done, fresh
    torch.cuda.empty_cache()
    return out


def phase_heisenberg(torch, dev, lat) -> dict:
    """Phase C: Heisenberg-DMI at full width with deterministic pair sums."""
    import shutil

    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md import analysis
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.neighbor import (assemble_pair_forces,
                                         assemble_pair_forces_plain,
                                         reverse_index)
    from repro_torch.md.state import init_state
    from repro_torch.telemetry import peak_device_memory
    run = main_path()
    dtype = getattr(torch, run.dtype)
    ham = HeisenbergDMIModel(**HEIS_B20)
    steps = HEIS_CHUNKS * HEIS_CHUNK
    log(f"phase C: Heisenberg-DMI {HEIS_B20} on B20 {run.unit_cells} = "
        f"{run.n_atoms} atoms, {HEIS_CHUNKS} x {HEIS_CHUNK} steps, midpoint "
        f"(2 iterations), {run.temperature} K, B={run.field} T")
    ckpt = SURFACE_DIR / "heisenberg_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def engine():
        state = init_state(lat, run.unit_cells, generator=torch.Generator(
            device=dev).manual_seed(31), temperature=run.temperature,
            dtype=dtype, device=dev)
        cfg = IntegratorConfig(dt=run.dt, lattice_gamma=run.lattice_gamma,
                               spin_alpha=run.spin_alpha, midpoint=True,
                               midpoint_iters=2)
        return Engine(ham, cfg, state,
                      torch.tensor(lat.masses, dtype=dtype, device=dev),
                      torch.tensor(lat.moments, device=dev) > 0, ham.cutoff,
                      temperature=run.temperature, field=run.field,
                      observables=FC_OBS, capacity=run.capacity,
                      skin=run.skin, use_cell_list=True,
                      cell_capacity=run.cell_capacity, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    torch.cuda.synchronize()
    peak_setup = peak_device_memory()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(33)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(steps, gen, chunk=HEIS_CHUNK, checkpoint_dir=str(ckpt),
            checkpoint_keep=2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = peak_device_memory()
    log(f"  {steps} steps in {secs:.3f} s = {steps / secs:.3f} steps/s "
        f"(5 evaluations a step), rebuilds {eng.n_rebuilds}, peak memory "
        f"{peak / 2**30:.2f} GiB in the run, {peak_setup / 2**30:.2f} GiB "
        f"in the construction (a table build, one evaluation), energy "
        f"{eng.energy:.6f} eV")
    for k, v in eng.trace.values.items():
        if not torch.isfinite(torch.as_tensor(v)).all():
            raise AssertionError(f"Heisenberg observable {k} non-finite")

    fresh = engine()
    gen_b = fresh.restore(str(ckpt), step=HEIS_CHUNK)
    fresh.run(steps - HEIS_CHUNK, gen_b, chunk=HEIS_CHUNK)
    same_run(torch, eng, fresh, slice(1, None), "Heisenberg resume")
    log("  resumed run is bitwise the uninterrupted one")

    # the deterministic reductions against index_add_ on the same inputs
    c = eng._carry
    nbh, spin, types = c.nbh, c.state.spin, c.state.types
    det = ham.compute(nbh, spin, types, run.field)
    again = ham.compute(nbh, spin, types, run.field)
    plain = ham.compute(nbh, spin, types, run.field, plain=True)
    plain2 = ham.compute(nbh, spin, types, run.field, plain=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(det, again)):
        raise AssertionError("two deterministic evaluations differ")
    errs = {name: check(f"Heisenberg {name} det vs index_add_", a, b, 2e-5)
            for name, a, b in zip("EFH", det, plain)}
    plain_repeat = [float((a - b).abs().max()) for a, b in zip(plain,
                                                               plain2)]
    log(f"  index_add_ twice on the same inputs: max |diff| E, F, H "
        f"{plain_repeat}")
    g = torch.randn(nbh.dr.shape, dtype=dtype, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(34))
    pos, box = c.state.pos, c.state.box
    times = {
        "pair_forces_ms": time_ms(torch, lambda: assemble_pair_forces(
            g, nbh), 20),
        "pair_forces_plain_ms": time_ms(
            torch, lambda: assemble_pair_forces_plain(g, nbh), 20),
        "reverse_index_ms": time_ms(torch, lambda: reverse_index(nbh.idx),
                                    5),
        "spin_grid_ms": time_ms(torch, lambda: analysis.accumulate_spin_grid(
            pos, spin, box), 20),
        "spin_grid_plain_ms": time_ms(
            torch, lambda: analysis.accumulate_spin_grid(pos, spin, box,
                                                         plain=True), 20),
        "evaluation_ms": time_ms(torch, lambda: ham.compute(
            nbh, spin, types, run.field), 5),
        "evaluation_plain_ms": time_ms(torch, lambda: ham.compute(
            nbh, spin, types, run.field, plain=True), 5),
    }
    grid_err = check("spin grid det vs index_add_",
                     analysis.accumulate_spin_grid(pos, spin, box),
                     analysis.accumulate_spin_grid(pos, spin, box,
                                                   plain=True), 2e-5)
    log(f"  times (ms): {times}")
    out = dict(steps_per_s=steps / secs, seconds=secs,
               rebuilds=eng.n_rebuilds, peak_memory_bytes=peak,
               peak_memory_setup_bytes=peak_setup,
               det_vs_plain_rel_err=errs, grid_rel_err=grid_err,
               plain_repeat_max_abs_diff=plain_repeat, **times)
    del eng, fresh, c, nbh, det, again, plain, plain2, g
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# later slices: the md_loop scenario, the replica plan, the ensemble layer
# ---------------------------------------------------------------------------

REPLICAS = 4
REP_CHUNKS, REP_CHUNK = 3, 20
REP_FLAT_STEPS = 10       # (c): a chunk short enough to trip no rebuild
REP_JITTER = 0.02         # A: each replica's positions, from its generator
REP_KERNEL_CELLS = (8, 8, 8)   # (b): phase 2's 4,096-atom lattice
# phase F's depth, cut for the time limit (the autograd Heisenberg-DMI
# evaluation loops over the replicas: ~80 ms a step for 8 films); the
# protocol keeps its shape (its knots scale with the step count)
NUCLEATION_STEPS = 500     # of nucleation_ensemble()'s 2,000
SWEEP_STEPS = 100          # of nucleation_ensemble_smoke()'s 300
TEMPERING_CHUNKS = 8       # of 10 steps, on nucleation_ensemble()'s film


def md_loop_kernels(torch, kern, ref, sim) -> dict:
    """Phase D's kernels on the md_loop path's own inputs: the kernel
    path's table, blocks and spins after its timed run (4,096 simple-cubic
    atoms, M = 8, the md_loop spec), K1 and K2 in both bodies against the
    plain versions at f32 (1e-4) and, on the same inputs cast, f64
    (1e-9)."""
    from repro_torch.core.potential import NEPSpinParams
    c = sim._engine._carry
    spec, types = sim.potential.spec, c.state.types
    errs = {"nep_atom_pass": {}, "nep_force_pass": {}}
    for dtype, bar, tag in ((torch.float32, 1e-4, "f32"),
                            (torch.float64, 1e-9, "f64")):
        params = NEPSpinParams(*(p.to(dtype) for p in sim.potential.params))
        dr, spin = c.nbh.dr.to(dtype), c.state.spin.to(dtype)
        sj = spin[c.nbh.idx.long()]
        blocks = (dr, c.nbh.mask, types, c.nbh.tj, spin, sj)
        want1 = ref.atom_pass_plain(spec, params, *blocks)
        k2_args = (dr, c.nbh.mask, c.nbh.idx, types, c.nbh.tj, spin, sj,
                   want1[2])
        want2 = ref.force_pass_plain(spec, params, *k2_args)
        for body in kern.BODIES:
            got1 = kern.nep_atom_pass(spec, params, *blocks, body=body)
            got2 = kern.nep_force_pass(spec, params, *k2_args, body=body)
            torch.cuda.synchronize()
            e1 = max(check(f"K1 md_loop {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("e", "hdir", "abar"), got1, want1))
            e2 = max(check(f"K2 md_loop {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("F", "h2"), got2, want2))
            errs["nep_atom_pass"][f"{body}_{tag}"] = e1
            errs["nep_force_pass"][f"{body}_{tag}"] = e2
    return errs


def phase_md_loop(torch, kern, ref) -> dict:
    """Phase D: the md_loop scenario (launch/md_loop.py) with its gates;
    every K1 and K2 launch of the kernel path in the warp body; then both
    kernels, both bodies, against their plain versions on the path's own
    inputs."""
    from repro_torch.launch.md_loop import run_scenario
    log("phase D: the md_loop scenario, simple cubic 16^3 = 4,096 atoms, "
        "chunk 20, skin 0.2, capacity 8, 500 K")
    sims = {}
    out = run_scenario("cuda", keep=sims)
    kp = out["potentials"]["nep_kernel"]
    for name, c in kp["fused"]["launches"].items():
        if c["total"] == 0 or c["warp"] != c["total"] or c["thread"]:
            raise AssertionError(f"md_loop kernel path: {name} launches {c}"
                                 ", expected all in the warp body")
    log(f"  vs_autodiff {kp['vs_autodiff']:.3f}; kernel-path launches "
        f"{kp['fused']['launches']}; telemetry overhead "
        f"{100 * out['telemetry']['overhead_vs_fused']:.1f}%")
    out["kernel_rel_err"] = md_loop_kernels(
        torch, kern, ref, sims["nep_kernel", "fused"])
    del sims
    torch.cuda.empty_cache()
    return out


def replica_states(torch, dev, lat, cells, dtype, seed, temperature):
    """REPLICAS distinct states: each replica's velocities and a small
    position jitter drawn from its own generator."""
    from repro_torch.md.state import init_state, stack_states
    sts = []
    for r in range(REPLICAS):
        g = torch.Generator(device=dev).manual_seed(seed + r)
        st = init_state(lat, cells, generator=g, temperature=temperature,
                        dtype=dtype, device=dev)
        jit = REP_JITTER * torch.randn(st.pos.shape, generator=g,
                                       dtype=dtype, device=dev)
        sts.append(st._replace(pos=torch.remainder(st.pos + jit, st.box)))
    return stack_states(sts)


def replica_kernels(torch, dev, spec, lat, kern, ref) -> dict:
    """Phase E (b): K1 and K2 on a replica batch (R = 4, B20 8x8x8, both
    bodies) against the plain versions at f64 (1e-9) and f32 (1e-4), and
    replica r of each batched launch bitwise against a flat launch on
    replica r's inputs."""
    from repro_torch.core.potential import NEPSpinParams, init_params
    from repro_torch.md.neighbor import (cell_neighbor_table, reference_pos,
                                         shared_blocks)
    errs = {"nep_atom_pass": {}, "nep_force_pass": {}}
    p64 = init_params(spec, torch.Generator(device=dev).manual_seed(41),
                      dtype=torch.float64, device=dev)
    for dtype, bar, tag in ((torch.float64, 1e-9, "f64"),
                            (torch.float32, 1e-4, "f32")):
        st = replica_states(torch, dev, lat, REP_KERNEL_CELLS, dtype, 50,
                            0.0)
        g = torch.Generator(device=dev).manual_seed(42)
        spin = torch.nn.functional.normalize(torch.randn(
            st.spin.shape, generator=g, dtype=dtype, device=dev), dim=-1)
        spin = spin * (st.spin.norm(dim=-1, keepdim=True) > 0)
        params = NEPSpinParams(*(p.to(dtype) for p in p64))
        box, types = st.box[0], st.types[0]
        tab = cell_neighbor_table(reference_pos(st.pos, box), box,
                                  spec.cutoff, 64, cell_capacity=32)
        nbh = shared_blocks(tab, types, st.pos, box)
        sj = spin[:, nbh.idx.long()]
        blocks = (nbh.dr, nbh.mask, types, nbh.tj, spin, sj)
        want1 = ref.atom_pass_plain(spec, params, *blocks)
        k2_args = (nbh.dr, nbh.mask, nbh.idx, types, nbh.tj, spin, sj,
                   want1[2])
        want2 = ref.force_pass_plain(spec, params, *k2_args)
        for body in kern.BODIES:
            got1 = kern.nep_atom_pass(spec, params, *blocks, body=body)
            got2 = kern.nep_force_pass(spec, params, *k2_args, body=body)
            torch.cuda.synchronize()
            e1 = max(check(f"K1 R={REPLICAS} {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("e", "hdir", "abar"), got1, want1))
            e2 = max(check(f"K2 R={REPLICAS} {body} {o} {tag}", a, b, bar)
                     for o, a, b in zip(("F", "h2"), got2, want2))
            for r in range(REPLICAS):
                flat1 = kern.nep_atom_pass(
                    spec, params, nbh.dr[r], nbh.mask, types, nbh.tj,
                    spin[r], sj[r], body=body)
                flat2 = kern.nep_force_pass(
                    spec, params, nbh.dr[r], nbh.mask, nbh.idx, types,
                    nbh.tj, spin[r], sj[r], want1[2][r], body=body)
                for o, a, b in zip(("e", "hdir", "abar", "F", "h2"),
                                   (*got1, *got2), (*flat1, *flat2)):
                    if not torch.equal(a[r], b):
                        raise AssertionError(
                            f"{body} {tag}: replica {r}'s {o} of the "
                            "batched launch is not the flat launch's")
            if body == "warp":
                errs["nep_atom_pass"][tag] = e1
                errs["nep_force_pass"][tag] = e2
        log(f"  {tag}: every replica of the batched launches bitwise the "
            "flat launch, both bodies")
    torch.cuda.empty_cache()
    return errs


def replica_engine(torch, dev, spec, params, lat, moments, states, **kw):
    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import NEPSpinPotential
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.parallel.plan import Replicated
    run = main_path()
    dtype = states.pos.dtype
    temp, field = protocol.field_cooling(
        FC_T["t_hot"], FC_T["t_cold"], FC_T["b_field"],
        t_hold=FC_T["t_hold"], t_ramp=FC_T["t_ramp"])
    cfg = kw.pop("cfg", IntegratorConfig(dt=run.dt,
                                         lattice_gamma=run.lattice_gamma,
                                         spin_alpha=run.spin_alpha))
    return Engine(
        NEPSpinPotential(spec, params, moments.to(dtype), use_kernel=True),
        cfg, states, torch.tensor(lat.masses, dtype=dtype, device=dev),
        torch.tensor(lat.moments, device=dev) > 0, spec.cutoff,
        plan=kw.pop("plan", Replicated(REPLICAS)), temperature=temp,
        field=field, capacity=run.capacity, skin=run.skin,
        use_cell_list=True, cell_capacity=run.cell_capacity, device=dev,
        **kw)


def same_replicas(torch, a, b, what, slots=None):
    for k in ("pos", "vel", "spin"):
        x, y = getattr(a.state, k), getattr(b.state, k)
        for r in (range(x.shape[0]) if slots is None else slots):
            if not torch.equal(x[r], y[r]):
                d = float((x[r] - y[r]).abs().max())
                raise AssertionError(f"{what}: replica {r}'s {k} differs "
                                     f"(max |diff| {d:.3e})")


def phase_replica(torch, dev, spec, lat, moments, kern, ref) -> dict:
    """Phase E: the Replicated plan at full width (4 x 262,144 atoms)."""
    import shutil

    import numpy as np

    from repro_torch.configs.fege_spinlattice import main_path
    from repro_torch.core.potential import init_params
    from repro_torch.ensemble.replica import spawn_generators
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import init_state, stack_states, unstack_state
    from repro_torch.parallel.plan import SingleDevice
    from repro_torch.telemetry import peak_device_memory
    run = main_path()
    dtype = getattr(torch, run.dtype)
    steps = REP_CHUNKS * REP_CHUNK
    log(f"phase E: Replicated({REPLICAS}) x B20 {run.unit_cells} = "
        f"{REPLICAS} x {run.n_atoms} atoms, field cooling {FC_T}, "
        f"{REP_CHUNKS} x {REP_CHUNK} steps, K1/K2 batched over the replicas")
    errs = replica_kernels(torch, dev, spec, lat, kern, ref)
    params = init_params(spec, torch.Generator(device=dev).manual_seed(43),
                         dtype=dtype, device=dev)

    def states():
        return replica_states(torch, dev, lat, run.unit_cells, dtype, 60,
                              FC_T["t_hot"])

    # (a) the run, every evaluation one K1 and one K2 launch for all R
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_md_counters(kern)
    eng = replica_engine(torch, dev, spec, params, lat, moments, states())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(steps, spawn_generators(61, REPLICAS, dev), chunk=REP_CHUNK)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = peak_device_memory()
    counts = read_md_counters(kern)
    expect = 1 + steps + eng.n_rebuilds
    n_atoms = eng.state.pos.shape[1]
    log(f"  {steps} steps of {REPLICAS} replicas in {secs:.3f} s = "
        f"{steps / secs:.3f} steps/s, {REPLICAS * steps / secs:.3f} "
        f"replica-steps/s, {REPLICAS * n_atoms * steps / secs:.4e} "
        f"atom-steps/s; rebuilds {eng.n_rebuilds}; launches {counts}; peak "
        f"memory {peak / 2**30:.2f} GiB")
    for name, (n, by_body) in counts.items():
        if n != expect or by_body != {"warp": expect, "thread": 0}:
            raise AssertionError(f"{name}: launches {n} by body {by_body}, "
                                 f"expected {expect} (one per evaluation "
                                 "for all replicas), all warp")
    for k, v in eng.trace.values.items():
        if v.shape[:2] != (REP_CHUNKS, REPLICAS) or not np.isfinite(v).all():
            raise AssertionError(f"replica observable {k}: shape {v.shape} "
                                 "or non-finite values")
    for k in ("pos", "vel", "spin"):
        if not bool(torch.isfinite(getattr(eng.state, k)).all()):
            raise AssertionError(f"replica state {k} non-finite")
    out = dict(steps_per_s=steps / secs,
               replica_steps_per_s=REPLICAS * steps / secs,
               atom_steps_per_s=REPLICAS * n_atoms * steps / secs,
               seconds=secs, rebuilds=eng.n_rebuilds, launches=expect,
               peak_memory_bytes=peak, kernel_rel_err=errs)

    # K1/K2 per batched launch beside R flat launches, in turns
    c = eng._carry
    nbh, spin, types = c.nbh, c.states.spin, eng._types0
    sj = spin[:, nbh.idx.long()]
    e, hdir, abar = kern.nep_atom_pass(spec, params, nbh.dr, nbh.mask, types,
                                       nbh.tj, spin, sj)
    def rows(x, r):          # the batch, or replica r's rows
        return x if r is None else x[r]

    def k1(r=None):
        return kern.nep_atom_pass(spec, params, rows(nbh.dr, r), nbh.mask,
                                  types, nbh.tj, rows(spin, r), rows(sj, r))

    def k2(r=None):
        return kern.nep_force_pass(spec, params, rows(nbh.dr, r), nbh.mask,
                                   nbh.idx, types, nbh.tj, rows(spin, r),
                                   rows(sj, r), rows(abar, r))

    times = {}
    for name, fn in (("nep_atom_pass", k1), ("nep_force_pass", k2)):
        t = {"batched": [], "flat": []}
        for how in ("batched", "flat", "flat", "batched"):
            t[how].append(time_ms(torch, fn if how == "batched" else (
                lambda: [fn(r) for r in range(REPLICAS)]), 10))
        times[name] = {"batched_ms": sum(t["batched"]) / 2,
                       "flat_ms": sum(t["flat"]) / 2}
    log(f"  K1/K2 at R={REPLICAS}: one batched launch vs {REPLICAS} flat "
        f"launches (ms): {times}")
    out["kernel_ms"] = times
    out["blocks_bytes"] = {"dr": nbytes(nbh.dr), "sj": nbytes(sj),
                           "abar": nbytes(abar),
                           "table": nbytes(nbh.idx, nbh.mask, nbh.tj)}
    del c, nbh, spin, sj, e, hdir, abar, k1, k2

    # (c) one chunk of the batch bitwise 4 flat Engines with its table
    rep = replica_engine(torch, dev, spec, params, lat, moments, states())
    table0 = rep.table           # the shared table before the chunk
    rep.run(REP_FLAT_STEPS, spawn_generators(62, REPLICAS, dev),
            chunk=REP_FLAT_STEPS)
    gens = spawn_generators(62, REPLICAS, dev)
    st0 = states()
    flats = []
    for r in range(REPLICAS):
        flat = replica_engine(torch, dev, spec, params, lat, moments,
                              unstack_state(st0, r),
                              plan=SingleDevice(cell_order=False),
                              table=table0)
        flat.run(REP_FLAT_STEPS, gens[r], chunk=REP_FLAT_STEPS)
        if flat.n_rebuilds or rep.n_rebuilds:
            raise AssertionError("(c) needs a chunk without rebuilds: "
                                 f"{flat.n_rebuilds}, {rep.n_rebuilds}")
        for k in ("pos", "vel", "spin"):
            if not torch.equal(getattr(flat.state, k),
                               getattr(rep.state, k)[r]):
                raise AssertionError(f"(c) replica {r}'s {k} is not the "
                                     "flat Engine's")
        if flat.energy != float(rep.energy[r]):
            raise AssertionError(f"(c) replica {r}'s energy differs")
        flats.append(flat.energy)
        del flat
    log(f"  (c) a {REP_FLAT_STEPS}-step chunk of the batch is bitwise "
        f"{REPLICAS} flat Engines on its table (energies {flats})")
    del rep

    # (d) checkpoints every chunk leave the run as it was; a resume from
    # the chunk-1 checkpoint is bitwise the uninterrupted run
    ckpt = SURFACE_DIR / "replica_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    again = replica_engine(torch, dev, spec, params, lat, moments, states())
    again.ckpt_pin = REP_CHUNK
    again.run(steps, spawn_generators(61, REPLICAS, dev), chunk=REP_CHUNK,
              checkpoint_dir=str(ckpt), checkpoint_keep=2)
    same_replicas(torch, eng, again, "checkpointed run")
    fresh = replica_engine(torch, dev, spec, params, lat, moments, states())
    gens = fresh.restore(str(ckpt), step=REP_CHUNK)
    fresh.run(steps - REP_CHUNK, gens, chunk=REP_CHUNK)
    same_replicas(torch, eng, fresh, "replica resume")
    if (fresh.n_rebuilds != eng.n_rebuilds or not np.array_equal(
            fresh.trace.values["energy"], eng.trace.values["energy"][1:])):
        raise AssertionError("replica resume: rebuilds or trace differ")
    log(f"  (d) the resumed run is bitwise the uninterrupted one (rebuilds "
        f"{fresh.n_rebuilds}, trace rows)")
    del again, fresh, eng

    # (e) per-slot mode, frozen lattice: a job seated in slot 2 between
    # chunks leaves slots 0, 1 and 3 bitwise as they were
    frozen = IntegratorConfig(dt=run.dt, spin_alpha=run.spin_alpha,
                              frozen_lattice=True)
    runs = []
    for write in (False, True):
        e_ = replica_engine(torch, dev, spec, params, lat, moments, states(),
                            cfg=frozen, per_slot=True)
        gens = spawn_generators(63, REPLICAS, dev)
        e_.run(REP_CHUNK, gens, chunk=REP_CHUNK)
        if write:
            job = init_state(lat, run.unit_cells, generator=torch.Generator(
                device=dev).manual_seed(64), temperature=FC_T["t_hot"],
                dtype=dtype, device=dev)
            e_.write_slots([2], stack_states([job]))
            gens[2] = torch.Generator(device=dev).manual_seed(65)
        e_.run(REP_CHUNK, gens, chunk=REP_CHUNK)
        runs.append(e_)
    same_replicas(torch, runs[0], runs[1], "per-slot write_slots",
                  slots=(0, 1, 3))
    h = runs[1].trace.health
    log(f"  (e) per-slot: slots 0, 1, 3 bitwise unchanged by write_slots "
        f"into slot 2; clocks {runs[1].state.step.tolist()}; slot health "
        f"{ {k: h[k][-1].tolist() for k in ('slot_nonfinite', 'slot_e_drift', 'slot_spin_dev')} }")
    del runs, e_
    torch.cuda.empty_cache()
    return out


def phase_ensemble(torch, dev) -> dict:
    """Phase F: the ensemble layer at the reference's sizes."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.fege_spinlattice import (
        nucleation_ensemble, nucleation_ensemble_smoke)
    from repro_torch.ensemble import protocol
    from repro_torch.ensemble.replica import (ReplicaEnsemble, replicate,
                                              spawn_generators)
    from repro_torch.ensemble.sweep import run_sweep
    from repro_torch.launch import ensemble_rate, skyrmion_nucleation
    from repro_torch.launch.sweep import build_film
    from repro_torch.md.integrator import IntegratorConfig
    ecfg = dataclasses.replace(nucleation_ensemble(),
                               n_steps=NUCLEATION_STEPS)
    log(f"phase F: the ensemble layer: {ecfg.name} ({ecfg.n_replicas} x "
        f"{ecfg.n_cells} film, {ecfg.n_steps} steps, Heisenberg-DMI), "
        "parallel tempering, run_sweep, ensemble_rate")
    out = {}
    t0 = time.perf_counter()
    q_th = skyrmion_nucleation.run(True, ecfg.n_steps, ecfg.n_replicas,
                                   ecfg.b_field, device=dev, log=lambda *a:
                                   None)
    t1 = time.perf_counter()
    q_cold = skyrmion_nucleation.run(False, ecfg.n_steps, 1, ecfg.b_field,
                                     device=dev, log=lambda *a: None)
    t2 = time.perf_counter()
    chunks = ecfg.n_steps // ecfg.chunk
    if q_th.shape != (chunks, ecfg.n_replicas) or q_cold.shape != (
            chunks, 1) or not (np.isfinite(q_th).all()
                               and np.isfinite(q_cold).all()):
        raise AssertionError(f"nucleation: charges {q_th.shape}, "
                             f"{q_cold.shape} or non-finite")
    out["nucleation"] = dict(
        skyrmion_nucleation.summarize(q_th, q_cold), thermal_s=t1 - t0,
        cold_s=t2 - t1, n_atoms=int(np.prod(ecfg.n_cells)),
        thermal_replica_steps_per_s=ecfg.n_replicas * ecfg.n_steps
        / (t1 - t0), cold_steps_per_s=ecfg.n_steps / (t2 - t1))
    log(f"  nucleation: {out['nucleation']}")

    # tempering on the nucleation ensemble's film (32x32x1), a 4-rung
    # ladder over its protocol's range, a swap attempt every chunk
    lat, ham, st = build_film(ecfg, 0, dev)
    ens = ReplicaEnsemble(
        potential=ham, cfg=IntegratorConfig(
            dt=ecfg.dt, lattice_gamma=ecfg.lattice_gamma,
            spin_alpha=ecfg.spin_alpha),
        states=replicate(st, 4),
        masses=torch.tensor(lat.masses, dtype=torch.float32, device=dev),
        magnetic=torch.tensor(lat.moments, device=dev) > 0, cutoff=5.0,
        capacity=8, diag_grid=(32, 32), device=dev)
    t0 = time.perf_counter()
    tr = ens.run(TEMPERING_CHUNKS * 10, spawn_generators(70, 4, dev),
                 temperature=protocol.temperature_ladder(
                     ecfg.t_cold, ecfg.t_hot, 4),
                 chunk=10, exchange_every=1,
                 exchange_generator=torch.Generator().manual_seed(71))
    # parity alternates: 2 pairs, then 1, per chunk
    attempts = 3 * TEMPERING_CHUNKS // 2
    if (tr.exchange_attempts != attempts
            or not 0 < tr.exchange_accepts <= attempts):
        raise AssertionError(f"parallel tempering: {tr.exchange_accepts} of "
                             f"{tr.exchange_attempts} swaps accepted")
    out["tempering"] = {"accepts": tr.exchange_accepts,
                        "attempts": tr.exchange_attempts,
                        "n_atoms": int(st.pos.shape[0]),
                        "seconds": time.perf_counter() - t0}
    log(f"  parallel tempering (4 x {ecfg.n_cells} films, ladder "
        f"{ecfg.t_cold:g}-{ecfg.t_hot:g} K, {TEMPERING_CHUNKS} chunks of 10 "
        f"steps): {tr.exchange_accepts} of {tr.exchange_attempts} swaps "
        "accepted")

    scfg = nucleation_ensemble_smoke()
    lat, ham, st = build_film(scfg, 0, dev)
    t0 = time.perf_counter()
    pd = run_sweep(
        st, ham, IntegratorConfig(dt=scfg.dt,
                                  lattice_gamma=scfg.lattice_gamma,
                                  spin_alpha=scfg.spin_alpha),
        torch.tensor(lat.masses, dtype=torch.float32, device=dev),
        torch.tensor(lat.moments, device=dev) > 0,
        scfg.sweep_temperatures, scfg.sweep_fields,
        n_replicas=scfg.n_replicas, n_steps=SWEEP_STEPS, seed=72,
        cutoff=5.0, capacity=8, chunk=scfg.chunk, device=dev)
    grid = (len(scfg.sweep_temperatures), len(scfg.sweep_fields))
    for k in ("charge", "charge_abs", "charge_std", "magnetization", "pitch",
              "energy"):
        v = getattr(pd, k)
        if v.shape != grid or not np.isfinite(v).all():
            raise AssertionError(f"run_sweep: {k} {v.shape} not filled")
    out["sweep"] = {"seconds": time.perf_counter() - t0,
                    "charge_abs": pd.charge_abs.tolist(),
                    "magnetization": pd.magnetization.tolist()}
    log(f"  run_sweep {grid} x {scfg.n_replicas} replicas: "
        f"{out['sweep']}")
    out["rate"] = ensemble_rate.measure(dev)
    log(f"  ensemble_rate (16x16x1, chunk 50): {out['rate']}")
    torch.cuda.empty_cache()
    return out



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
    ptxas = {}
    for name in _build.SOURCES:
        ptxas[name] = ptxas_report(
            _build.library_path(name).with_suffix(".log").read_text())
        for kernel, rep in ptxas[name].items():
            if "registers" in rep:
                log(f"  ptxas {name}: {kernel}: {rep}")

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
        want = ref.atom_pass_plain(spec, params, *blocks)
        wl = unpack_abar(spec, want[2])
        for body in kern.BODIES:
            got = kern.nep_atom_pass(spec, params, *blocks, body=body)
            torch.cuda.synchronize()
            worst = max(check(f"K1 {body} e {tag}", got[0], want[0], bar),
                        check(f"K1 {body} hdir {tag}", got[1], want[1], bar))
            gl = unpack_abar(spec, got[2])
            for k in wl:
                worst = max(worst, check(f"K1 {body} abar.{k} {tag}", gl[k],
                                         wl[k], bar))
            if body == kern.atom_pass_body(spec):
                errs["nep_atom_pass"][tag] = worst
        k2_args = (spec, params, nbh.dr, nbh.mask, nbh.idx, st.types, nbh.tj,
                   st.spin, sj, want[2])
        fp = ref.force_pass_plain(*k2_args)
        for body in kern.BODIES:
            fk = kern.nep_force_pass(*k2_args, body=body)
            torch.cuda.synchronize()
            err = max(check(f"K2 {body} F {tag}", fk[0], fp[0], bar),
                      check(f"K2 {body} h2 {tag}", fk[1], fp[1], bar))
            if body == kern.force_pass_body(spec):
                errs["nep_force_pass"][tag] = err
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
    for fn in (kern.nep_atom_pass, kern.nep_force_pass):
        fn.launches = 0
        fn.body_launches = dict.fromkeys(kern.BODIES, 0)
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
    body_launches = {"nep_atom_pass": dict(kern.nep_atom_pass.body_launches),
                     "nep_force_pass": dict(
                         kern.nep_force_pass.body_launches)}
    st, ff = eng.state, eng._ff
    expect = 1 + steps + eng.n_rebuilds
    log(f"  grid {eng._n_cells}, setup {setup_s:.2f} s, {steps} steps in "
        f"{run_s:.3f} s = {steps / run_s:.3f} steps/s, "
        f"rebuilds {eng.n_rebuilds}, launches {launches} "
        f"(expect {expect} each), by body {body_launches}")
    for name, n in launches.items():
        if n != expect:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"1 + steps + rebuilds = {expect}")
        if body_launches[name] != {"warp": expect, "thread": 0}:
            raise AssertionError(f"{name} launches by body "
                                 f"{body_launches[name]}: the main path "
                                 "must run the warp body only")
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
    k1_thread = kern.nep_atom_pass(spec, params, *blocks, body="thread")
    k2 = kern.nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                             nbh.tj, spin, sj, p1[2])
    k2_thread = kern.nep_force_pass(spec, params, nbh.dr, nbh.mask, nbh.idx,
                                    types, nbh.tj, spin, sj, p1[2],
                                    body="thread")
    p2 = ref.force_pass_plain(spec, params, nbh.dr, nbh.mask, nbh.idx, types,
                              nbh.tj, spin, sj, p1[2])
    torch.cuda.synchronize()
    for o, a, b in zip(("e", "hdir", "abar"), k1_thread, p1):
        check(f"K1 thread {o} main", a, b, 1e-4)
    for o, a, b in zip(("F", "h2"), k2_thread, p2):
        check(f"K2 thread {o} main", a, b, 1e-4)
    del k1_thread, k2_thread
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
    # each kernel's bodies in turns: warp, thread, thread, warp
    calls = {"nep_atom_pass": (kern.nep_atom_pass, k1_args),
             "nep_force_pass": (kern.nep_force_pass, k2_args)}
    by_body = {}
    for name, (fn, fargs) in calls.items():
        by_body[name] = {"warp": [], "thread": []}
        for body in ("warp", "thread", "thread", "warp"):
            by_body[name][body].append(time_ms(
                torch, lambda: fn(*fargs, body=body), 20))
        log(f"  {name} by body, in turns (ms): {by_body[name]}")
    ms = {name: sum(t["warp"]) / 2 for name, t in by_body.items()}
    ptx = {"nep_atom_pass": (PTXAS_K1_WARP, PTXAS_K1_THREAD),
           "nep_force_pass": (PTXAS_K2_WARP, PTXAS_K2_THREAD)}
    extra = {name: {"body": "warp",
                    "previous_ms": sum(by_body[name]["thread"]) / 2,
                    "previous_body": "thread",
                    "ptxas": ptxas_of(ptxas, *ptx[name][0]),
                    "previous_ptxas": ptxas_of(ptxas, *ptx[name][1])}
             for name in calls}
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
    for name, (b, f) in work.items():
        meta = KERNELS[name]
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
            "library_ms": None, **extra[name],
        })
    log(f"  main path step {step_ms:.2f} ms, of which K1 + K2 "
        f"{ms['nep_atom_pass'] + ms['nep_force_pass']:.2f} ms per evaluation")
    del eng, c, nbh, blocks, k1, p1, k2, p2, state, st, ff
    torch.cuda.empty_cache()

    rows += lm_phases(torch, dev, ptxas)
    torch.cuda.empty_cache()
    surface = {"field_cooling": phase_field_cooling(torch, dev, spec, lat,
                                                    moments, kern)}
    surface["heisenberg"] = phase_heisenberg(torch, dev, lat)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_field_cooling"] = surface["field_cooling"][
                "profiled"]["launches"]
    print(json.dumps({"md_surface": surface}), flush=True)
    md_loop = phase_md_loop(torch, kern, ref)
    print(json.dumps({"md_loop": md_loop}), flush=True)
    replica = phase_replica(torch, dev, spec, lat, moments, kern, ref)
    for row in rows:
        if row["name"] in ("nep_atom_pass", "nep_force_pass"):
            row["launches_replica"] = replica["launches"]
            row["replica_ms"] = replica["kernel_ms"][row["name"]][
                "batched_ms"]
            row["replica_flat_ms"] = replica["kernel_ms"][row["name"]][
                "flat_ms"]
            row["max_rel_err_replica"] = replica["kernel_rel_err"][
                row["name"]]
            row["max_rel_err_md_loop"] = md_loop["kernel_rel_err"][
                row["name"]]
    print(json.dumps({"replica_plan": replica}), flush=True)
    print(json.dumps({"ensemble": phase_ensemble(torch, dev)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
