"""``BENCHMARK.json`` and the files it names, found by name.

A cell (a ``workloads`` entry) names a configuration and a traffic mix:

* ``configs[].file``: the configuration (``perfbench/configs/<config>.json``);
* ``perfbench/traffic/<traffic>.json``: the mix the general runner reads;
* ``perfbench/checks/<workload>.json``: the limits its check holds;
* ``perfbench/metrics/<metric>.py``: one reader a metric, ``read(ctx)``;
* ``perfbench/plans/<plan>.py``: how the engine is laid over the cards,
  named by the mix's ``plan``;
* ``perfbench/models/<kind>.py``: the potential, its weights, its plain
  reference and its work, named by the configuration's
  ``potential.kind``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path}")
    return json.loads(path.read_text())


def metrics_of(bench: dict, workload: str) -> dict:
    """The end-to-end and per-layer metrics the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell runs on: ``workload``, ``config``, ``traffic``,
    ``limits`` and ``metrics``."""
    bench = load(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    return compose(found[0], bench, root)


def compose(w: dict, bench: dict, root: Path = ROOT) -> dict:
    """:func:`cell` of a ``workloads`` entry ``w``."""
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return {"workload": w, "config": _json(root / conf["file"]),
            "traffic": _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
            "limits": _json(BENCH_DIR / "checks" / f"{w['name']}.json"),
            "metrics": metrics_of(bench, w["name"])}


def module(folder: str, name: str, root: Path = ROOT):
    """The module ``perfbench/<folder>/<name>.py``, loaded from its file
    (a name may hold ``-`` and ``.``, which an import statement cannot)."""
    path = root / "perfbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {path}")
    key = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{key}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``perfbench/metrics/<metric>.py``, and how the
    readings of several cards combine (its ``COMBINE``: ``"mean"``, the
    default, or ``"max"``)."""
    mod = module("metrics", metric, root)
    return mod.read, getattr(mod, "COMBINE", "mean")


def plan(name: str, root: Path = ROOT):
    """``perfbench/plans/<name>.py``."""
    return module("plans", name, root)


def model(config: dict, root: Path = ROOT):
    """``perfbench/models/<kind>.py`` of the configuration's potential."""
    return module("models", config["potential"]["kind"], root)
