"""The CI smoke suite (port of ``scripts/ci.sh --smoke``).

    PYTHONPATH=src python -m repro_torch.launch.ci_smoke [--device cpu]

Runs the port's counterpart of each ``python`` line of ``ci.sh --smoke``,
in its order, each in a child process, and stops at the first that exits
nonzero: the 2-rank engine smoke, the resilience smoke, the serving smoke,
the serve chaos smoke, the NEP kernel smoke (K1 and K2 on the card), the
docs link check and, for ``ci.sh``'s last line (``benchmarks.run --smoke
--strict``), the benchmark registry ``bench_run --smoke --strict``.
``--device`` goes to every step but the docs check.

``main`` returns ``{"ok", "steps": [{"step", "script", "rc",
"seconds"}]}``; run as a script it exits 1 unless every step passed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (the reference's script, the port's module under repro_torch.launch,
# whether it takes --device), in ci.sh --smoke's order
STEPS = (
    ("scripts/engine_smoke.py", "engine_smoke", True),
    ("scripts/resilience_smoke.py", "resilience_smoke", True),
    ("scripts/serve_smoke.py", "serve_smoke", True),
    ("scripts/serve_chaos_smoke.py", "serve_chaos_smoke", True),
    ("scripts/kernel_smoke.py", "kernel_smoke", True),
    ("scripts/check_docs.py", "check_docs", False),
    ("benchmarks/run.py", "bench_run", True),
)
# the flags of ci.sh's line, passed on
ARGS = {"bench_run": ("--smoke", "--strict")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    env = {**os.environ, "PYTHONPATH": _SRC + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    done = []
    for script, module, takes_device in STEPS:
        cmd = [sys.executable, "-m", f"repro_torch.launch.{module}",
               *ARGS.get(module, ())]
        if takes_device:
            cmd += ["--device", args.device]
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, env=env).returncode
        done.append({"step": module, "script": script, "rc": rc,
                     "seconds": time.perf_counter() - t0})
        print(f"[ci_smoke] {module}: rc {rc} "
              f"({done[-1]['seconds']:.1f} s)", flush=True)
        if rc != 0:
            break
    res = {"ok": len(done) == len(STEPS) and done[-1]["rc"] == 0,
           "steps": done}
    print(json.dumps({"ci_smoke": res}), flush=True)
    return res


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
