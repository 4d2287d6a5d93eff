"""Shared utilities of the port's benchmark drivers (port of
``benchmarks/common.py``).

The reference's two switches hold here too, read when a driver runs (not
when it is imported): ``BENCH_SMOKE=1`` runs every driver once on cut
problems, enough to catch rotted perf code, not to time it; ``BENCH_STRICT=1``
turns perf-regression warnings into failures.  Each driver also takes
``--smoke`` / ``--strict`` flags, which win over the environment.

The drivers write their JSON under ``build/bench/`` (git-ignored) or their
``--out`` directory, never at the repository root, where the reference's
``BENCH_*.json`` files live.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "build" / "bench"
# B20 unit cells a side up to which a table is the reference's all-pairs
# one (O(N^2) memory); linked-cell above
DENSE_MAX_CELLS = 8


def smoke() -> bool:
    return bool(os.environ.get("BENCH_SMOKE"))


def strict() -> bool:
    return bool(os.environ.get("BENCH_STRICT"))


def add_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every driver takes: ``--device``, ``--out``, ``--smoke``,
    ``--strict``."""
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help=f"directory of the JSON (default {OUT_DIR})")
    ap.add_argument("--smoke", action="store_true",
                    help="one call on cut problems (or BENCH_SMOKE=1)")
    ap.add_argument("--strict", action="store_true",
                    help="perf warnings fail (or BENCH_STRICT=1)")
    return ap


def parse(ap: argparse.ArgumentParser, argv=None) -> argparse.Namespace:
    """Parse, folding the environment's switches into ``smoke`` / ``strict``
    and ``out`` into a :class:`Path`."""
    args = ap.parse_args(argv)
    args.smoke = args.smoke or smoke()
    args.strict = args.strict or strict()
    args.out = Path(args.out) if args.out else OUT_DIR
    return args


@contextlib.contextmanager
def switches(args: argparse.Namespace):
    """Hold ``BENCH_SMOKE`` / ``BENCH_STRICT`` at ``args``' values while a
    driver runs, and put the environment back after it."""
    saved = {k: os.environ.get(k) for k in ("BENCH_SMOKE", "BENCH_STRICT")}
    for key, on in (("BENCH_SMOKE", args.smoke), ("BENCH_STRICT",
                                                  args.strict)):
        if on:
            os.environ[key] = "1"
        else:
            os.environ.pop(key, None)
    try:
        yield
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, *args, device="cpu", warmup: int = 1, iters: int = 3,
           quick: bool | None = None) -> float:
    """Median wall seconds a call after ``warmup`` calls; every call ends in
    a synchronize on the card.  ``quick`` (default: the smoke switch) makes
    it one call and no warmup."""
    if smoke() if quick is None else quick:
        warmup, iters = 0, 1
    for _ in range(warmup):
        fn(*args)
        sync(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def row(name: str, us_per_call: float, derived: str = "") -> str:
    """Print and return one ``name,us_per_call,derived`` CSV row."""
    line = f"{name},{us_per_call:.1f},{derived}"
    print(line, flush=True)
    return line


def card_name_and_limit() -> str | None:
    """``nvidia-smi``'s ``name, power.limit`` of the first card, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else None


def provenance() -> dict:
    """What a number is comparable under: torch and CUDA versions, the
    card's name, count and power limit, the host's cores, the time."""
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
        "power_limit": card_name_and_limit() if cuda else None,
        "host_cores": os.cpu_count() or 1,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def write_json(path, payload: dict) -> Path:
    """Write ``payload`` with the provenance stamp attached."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = dict(payload, provenance=provenance())
    path.write_text(json.dumps(payload, indent=2, default=_jsonable))
    print(f"wrote {path}", flush=True)
    return path


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if hasattr(x, "item"):          # numpy scalars
        return x.item()
    raise TypeError(f"not JSON serialisable: {type(x)}")


def is_oom(exc: BaseException) -> bool:
    """Whether ``exc`` is the card (or the host) running out of memory."""
    return isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)) or (
        isinstance(exc, RuntimeError) and "out of memory" in str(exc))


def peak_gib(device) -> float | None:
    """Peak GiB torch allocated on the card since the last reset."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def nep_model(device, seed: int, **spec):
    """``(spec, params)``: a NEP-SPIN spec and its weights drawn from
    ``seed``, as the reference's drivers draw them."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.potential import init_params
    spec = NEPSpinSpec(**spec)
    return spec, init_params(spec, torch.Generator(
        device=device).manual_seed(seed), device=device)


def b20_state(device, cells: int, temperature: float, seed: int):
    """B20 FeGe at ``cells`` unit cells a side, f32, velocities at
    ``temperature`` drawn from ``seed``."""
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.state import init_state
    return init_state(b20_fege(), (cells,) * 3, temperature=temperature,
                      generator=torch.Generator(device=device).manual_seed(
                          seed), device=device)


def neighbor_table(st, cells: int, cutoff: float, capacity: int):
    """The table of a :func:`b20_state`: the reference's all-pairs
    ``dense_neighbor_table`` up to ``DENSE_MAX_CELLS``, the same table from
    ``md/neighbor.py:cell_neighbor_table`` above."""
    from repro_torch.md.neighbor import (cell_neighbor_table,
                                         dense_neighbor_table)
    if cells <= DENSE_MAX_CELLS:
        return dense_neighbor_table(st.pos, st.box, cutoff, capacity)
    return cell_neighbor_table(st.pos, st.box, cutoff, capacity,
                               cell_capacity=32)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
