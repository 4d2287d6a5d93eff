#!/usr/bin/env python3
"""The benchmark registry: one driver for each of the paper's tables and
figures (port of ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.launch.bench_run [--only a,b]
        [--smoke] [--strict] [--device cuda|cpu] [--out DIR]

  kernels     kernel-level rows: fused against plain (launch/kernel_rows.py)
  ablation    Fig. 5: the single-device optimisation ablation
  throughput  Fig. 6 / Table I: atom-steps/s and TtS against N
  scaling     Fig. 7/8 / Table V: weak scaling of the Sharded loop
  accuracy    Table IV: NEP-SPIN against its baselines
  ensemble    Fig. 9's engine: replica-batched chunks against sequential
              ones (launch/ensemble_rate.py)
  serve       the job server: drain, journal overhead, recovery replay
              (launch/serve_rate.py)
  md_loop     the fused MD loop against the legacy driver

Each selected driver runs in the registry's order, each in a child process
(which frees the card's memory between drivers), and every one runs even
when an earlier one failed; the run then exits 1 and names the failures.  Prints ``name,us_per_call,derived``
rows.  ``--smoke`` (or ``BENCH_SMOKE=1``) runs every driver once on cut
problems; ``--strict`` (or ``BENCH_STRICT=1``) turns perf warnings into
failures (md_loop's full-size ``nep_kernel.vs_autodiff >= 1.0``).  Each
driver writes its JSON under ``--out`` (default ``build/bench/``; md_loop's
into its ``md_loop/`` folder), never at the repository root.
``throughput`` runs with ``--kernel``, so K1 and K2 get rows; on the card
it and ``kernels`` fail if a kernel of their rows launched no time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.launch import bench_common as bc

# the reference's registry, in its order (cheap first) -> the port's module
REGISTRY = {
    "kernels": "kernel_rows",
    "ablation": "ablation",
    "throughput": "throughput",
    "scaling": "scaling",
    "accuracy": "accuracy",
    "ensemble": "ensemble_rate",
    "serve": "serve_rate",
    "md_loop": "md_loop",
}
EXTRA_ARGS = {"throughput": ["--kernel"]}
_SRC = str(Path(__file__).resolve().parents[2])


def driver_args(name: str, args) -> list[str]:
    """A driver's flags; the smoke and strict switches reach it through
    the environment (:func:`bench_common.switches`), as in the reference."""
    out = args.out / "md_loop" if name == "md_loop" else args.out
    return ["--device", args.device, "--out", str(out),
            *EXTRA_ARGS.get(name, [])]


def result_path(out, name: str) -> Path:
    """Where driver ``name`` writes its JSON under the run's ``out``."""
    if name == "md_loop":
        return Path(out) / "md_loop" / "md_loop.json"
    return Path(out) / f"{REGISTRY[name]}.json"


def _child(module: str, argv: list[str]) -> int:
    env = {**os.environ, "PYTHONPATH": _SRC + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    return subprocess.run([sys.executable, "-m",
                           f"repro_torch.launch.{module}", *argv],
                          env=env).returncode


def select(only: str | None) -> list[str]:
    """The registry's names, or the ``--only`` subset in registry order;
    an unknown name exits naming the registry."""
    if only is None:
        return list(REGISTRY)
    names = [n for n in only.split(",") if n]
    unknown = [n for n in names if n not in REGISTRY]
    if unknown or not names:
        raise SystemExit(f"unknown benchmark(s) {unknown}; registry: "
                         f"{', '.join(REGISTRY)}")
    return [n for n in REGISTRY if n in names]


def main(argv=None) -> dict:
    ap = bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    ap.add_argument("--only", default=None,
                    help=f"comma-separated subset of: {', '.join(REGISTRY)}")
    args = bc.parse(ap, argv)
    names = select(args.only)
    print("name,us_per_call,derived", flush=True)
    done = {}
    with bc.switches(args):
        for name in names:
            module = REGISTRY[name]
            t0 = time.perf_counter()
            rc = _child(module, driver_args(name, args))
            done[name] = {"module": module, "rc": rc,
                          "seconds": time.perf_counter() - t0}
    failed = [n for n, d in done.items() if d["rc"] != 0]
    res = {"ok": not failed, "failed": failed, "drivers": done,
           "out": str(args.out)}
    print(json.dumps({"bench_run": res}), flush=True)
    if failed:
        print(f"FAILED: {failed}", file=sys.stderr, flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
