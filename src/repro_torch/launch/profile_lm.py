#!/usr/bin/env python3
"""Where the time goes in the port's LM serving and training paths, on the
card.

    PYTHONPATH=src python3 -m repro_torch.launch.profile_lm [--trace DIR]
        [--arch zamba2-2.7b] [--layers N] [--train]

Builds the random-weight bf16 ``--arch`` (seed 0; ``--layers`` cuts its
depth, for an arch whose weights and caches do not fit one card), then
profiles with ``torch.profiler`` one prefill call at B=2, S=8,192 (after a
warm call; the encoder-decoder takes 8,192 source frames and 2,048 target
tokens) and 8 decode steps at B=8 against 8,192-slot caches (after 2 warm
steps; the encoder-decoder's cross K/V from an encoded batch).  Each
window runs twice, bare and under the profiler.  It prints the host wall
time of both (ending in a synchronize), the summed device time of every
kernel, the device's busy share (device time over the bare wall time), the
device time by kind (SSD kernel, flash-attention
kernel, cuBLAS matrix products, everything else) and the ten kernels with
the most device time.  ``--trace DIR`` also writes a Chrome trace of each
window there.

``--train`` profiles one training step instead (chip_smoke.py's phase
T(a) by default: qwen2-7b at full width, its depth cut by
``launch/train.py:train_depth`` to fit ``TRAIN_BUDGET_GIB``, B = 2 x S =
4,096 a microbatch, accumulation 2, remat, random bf16 weights at tp =
1 as ``train_lm`` builds them, the synthetic token stream; ``--train
--arch mamba2-2.7b`` or ``zamba2-2.7b`` is phase V's step, every layer
kept) after a warm step: device time by kind (SSD forward and backward, FA
forward, FA backward's dK/dV and dQ passes, cuBLAS, the rest), the busy
share, and the device time of the loss chunks' forward and recomputation
(their ``record_function`` range, which the kinds also count).  Needs one
CUDA card; imports torch and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ARCH = "zamba2-2.7b"
KINDS = (("ssd_chunks_bwd", ("ssd_chunk_bwd_kernel",
                               "ssd_chunk_bwd_tc_kernel")),
         ("ssd_chunks", ("ssd_chunk_kernel", "ssd_chunk_tc_kernel")),
         ("flash_attention_fwd", ("flash_fwd",)),
         # the backward's passes, either body (CUDA cores, tensor cores)
         ("flash_attention_bwd dK/dV", ("dkdv_kernel", "dkdv_tc_kernel")),
         ("flash_attention_bwd dQ", ("dq_kernel", "dq_tc_kernel")),
         ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass")))
TRAIN_ARCH = "qwen2-7b"
TRAIN_BUDGET_GIB = 60.0
TRAIN_B, TRAIN_S, TRAIN_ACCUM = 2, 4096, 2
XENT_RANGE = "chunked_xent"


def _kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other (elementwise, reductions, copies)"


def _wall(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile(torch, label, fn, trace_dir):
    """Device time of ``fn``'s kernels (events on the card only: the CPU
    ops' own device totals would count each kernel twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    bare = _wall(torch, fn)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = _wall(torch, fn)
    # the loss chunks' range also shows on the device's timeline: read it
    # apart, so that no kernel counts twice
    rows = [(e.key, float(e.self_device_time_total), e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != XENT_RANGE]
    ranges = {e.key: float(e.self_device_time_total) / 1e3
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.key == XENT_RANGE}
    rows = [r for r in rows if r[1] > 0]
    dev_ms = sum(r[1] for r in rows) / 1e3
    print(f"{label}: wall {1e3 * bare:.2f} ms unprofiled, "
          f"{1e3 * wall:.2f} ms profiled; device {dev_ms:.2f} ms = busy "
          f"{100 * dev_ms / (1e3 * bare):.1f} % of the unprofiled wall "
          f"time; {sum(r[2] for r in rows)} kernel launches", flush=True)
    if dev_ms == 0:
        raise RuntimeError("the profiler recorded no device time")
    by_kind = {}
    for key, us, _ in rows:
        by_kind[_kind(key)] = by_kind.get(_kind(key), 0.0) + us / 1e3
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:<42} {ms:10.3f} ms  {100 * ms / dev_ms:5.1f} %")
    for key, ms in ranges.items():
        print(f"  range {key} (forward + recomputation) {ms:10.3f} ms  "
              f"{100 * ms / dev_ms:5.1f} %")
    print("  top kernels by device time:")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"    {us / 1e3:10.3f} ms  x{n:<6} {key[:90]}")
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{label}.json"))
    return {"wall_ms": 1e3 * bare, "device_ms": dev_ms,
            "busy": dev_ms / (1e3 * bare), "by_kind_ms": by_kind,
            "ranges_ms": ranges}


def train_step_profile(torch, args, dev) -> dict:
    """One phase-T(a) training step under the profiler, after a warm one."""
    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_batches, to_tensors
    from repro_torch.launch.train import depth_cut, train_depth
    from repro_torch.models import lm
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import init_train_state, make_train_step
    cfg = configs.get(args.arch)
    if args.layers:
        cfg = depth_cut(cfg, args.layers)
    else:
        cfg, _ = train_depth(cfg, TRAIN_BUDGET_GIB)
    print(f"{cfg.name}: {cfg.n_layers} layers, training B={TRAIN_B} x "
          f"S={TRAIN_S} a microbatch, accum {TRAIN_ACCUM}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(lm.init_params(cfg, gen, tp=1, device=dev))
    step = make_train_step(lm.make_loss_fn(cfg, remat=True), lambda s:
                           cosine_schedule(s, peak_lr=3e-4, warmup=20,
                                           total=100), accum=TRAIN_ACCUM)
    batches = synthetic_batches(cfg, TRAIN_B * TRAIN_ACCUM, TRAIN_S, 0)
    box = {"state": state}

    def one():
        box["state"], _ = step(box["state"], to_tensors(next(batches), dev))
    one()
    return profile(torch, f"train_step_B{TRAIN_B * TRAIN_ACCUM}_S{TRAIN_S}",
                   one, args.trace)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None)
    ap.add_argument("--arch", default=None, help=f"default {ARCH}; with "
                    f"--train {TRAIN_ARCH}")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many (decoder) layers")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step (default arch "
                    f"{TRAIN_ARCH})")
    args = ap.parse_args()
    if args.arch is None:
        args.arch = TRAIN_ARCH if args.train else ARCH
    import torch
    if not torch.cuda.is_available():
        print("profile_lm: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build, configs
    from repro_torch.models import encdec, lm
    from repro_torch.models import transformer as tfm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.build(["ssd_chunks", "ssd_chunks_bwd", "flash_attention_fwd",
                  "flash_attention_bwd"])
    dev = torch.device("cuda")
    if args.train:
        train_step_profile(torch, args, dev)
        return 0
    cfg = configs.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"{cfg.name}: {cfg.n_layers} layers", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, gen, device=dev)

    tokens = torch.randint(0, cfg.vocab, (2, 8192), generator=gen,
                           device=dev)
    audio = cfg.family == "audio"
    dtype = getattr(torch, cfg.dtype)
    src = torch.randn((8, 8192, cfg.d_model), generator=gen, device=dev,
                      dtype=dtype) if audio else None
    batch = ({"src_embeds": src[:2], "tokens": tokens[:, :8192 // 4]}
             if audio else {"tokens": tokens})
    prefill = lm.make_prefill_fn(cfg)
    prefill(params, batch)
    profile(torch, "prefill_B2_S8192", lambda: prefill(params, batch),
            args.trace)
    del batch

    bsz = 8
    if audio:
        caches = encdec.fill_cross_kv(cfg, params, encdec.init_caches(
            cfg, bsz, 8192 // encdec.TGT_RATIO, 8192, dtype, dev), src)
        del src
    else:
        caches = tfm.init_caches(cfg, bsz, 8192, torch.bfloat16, dev)
    decode = lm.make_decode_fn(cfg)
    tok = torch.randint(0, cfg.vocab, (bsz, 1), generator=gen, device=dev)
    state = {"tok": tok, "pos": 0}

    def steps(n):
        for _ in range(n):
            pos = torch.full((bsz,), state["pos"], dtype=torch.int32,
                             device=dev)
            logits, _ = decode(params, caches, {"token": state["tok"],
                                                "position": pos})
            state["tok"] = logits.argmax(-1, keepdim=True)
            state["pos"] += 1

    steps(2)
    profile(torch, "decode_B8_T8192_8steps", lambda: steps(8), args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
