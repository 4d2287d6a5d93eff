#!/usr/bin/env python3
"""Run one cell of the benchmark (``BENCHMARK.json``) and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with as many NVIDIA cards as the cell names.
The run builds the model's kernels (``build/kernels/`` of the checkout,
first run only), makes the weights and the crystal from ``--seed`` on the
card(s), warms the cell's shapes, runs ``repro_torch``'s ``Engine`` on the
mix's plan chunk after chunk for ``--seconds`` (one rank a card on a cell
of several; with ``--trace 1`` under ``torch.profiler``), checks what it
produced against the plain reference (``perfbench/reference``) and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace
1``), and ``check``, each compared number beside its limit, which also
close standard error.

Two further modes, which measure nothing:

* ``--rehearse``: the cell's code on the CPU on a box of 4^3 unit cells a
  rank in chunks of two steps (the kernels' plain versions; gloo ranks
  for a cell of several cards), for the tests and to rehearse;
* ``--control``: the control of the check, the reference with TF32
  contractions in the program's place, read against the same limits (on
  one card at the cell's size, or with ``--rehearse``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return code


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return _fail(f"{ROOT} holds no src/repro_torch, the program under "
                     "test", 3)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from perfbench.harness import manifest
    try:
        cell = manifest.cell(args.workload, ROOT)
    except (FileNotFoundError, KeyError) as e:
        return _fail(str(e), 2)
    import torch
    chips = 1 if args.control else int(cell["workload"]["chips"])
    if not args.rehearse:
        if not torch.cuda.is_available():
            return _fail("no CUDA card: the benchmark measures the card "
                         "and never falls back to the CPU", 3)
        if torch.cuda.device_count() < chips:
            return _fail(f"the cell needs {chips} cards, the machine has "
                         f"{torch.cuda.device_count()}", 3)
        if chips == 1:      # several cards: each rank takes its own
            torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from perfbench.harness import runner
    result = runner.run(cell, args, T_START)
    found = sorted(set(runner.loaded_forbidden())
                   | set(result.pop("forbidden", [])))
    if found:
        return _fail("the run loaded " + ", ".join(found) + ": the "
                     "benchmark runs the port alone", 4)
    if result["device"]["platform"] == "gpu":
        result["device"]["power_limit_w"] = _power_limit()
    for name, value, limit in result["check_rows"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    del result["check_rows"]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
