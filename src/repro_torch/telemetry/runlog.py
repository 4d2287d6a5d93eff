"""Per-run JSONL event stream (port of ``repro.telemetry.runlog``).

One runlog = one file = one run.  Line 1 is a ``run_start`` header stamped
with :func:`provenance`, then one ``chunk`` record per engine chunk
(steps/s, compile delta, health signals and verdict), and a final
``run_end`` with totals.  Each record is flushed as it is written, so a
killed run keeps every completed chunk.
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import torch

SCHEMA_VERSION = 1


def _card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    out = {"device_name": torch.cuda.get_device_name(0),
           "device_count": torch.cuda.device_count()}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["nvidia_smi"] = None
    return out


def provenance() -> dict:
    """Environment stamp of the ``run_start`` header: torch and CUDA
    versions, and the card's name and power limit when one is present."""
    stamp = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "host_cores": os.cpu_count(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    if torch.cuda.is_available():
        stamp.update(_card())
    return stamp


def _jsonable(x):
    """Coerce tensors, numpy scalars and containers to plain JSON types."""
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if hasattr(x, "tolist"):
        return _jsonable(x.tolist())
    if isinstance(x, float):
        return x if x == x and abs(x) != float("inf") else repr(x)
    return x


class RunLog:
    """Append-only JSONL writer for one run; ``mode="a"`` continues an
    existing runlog (retry segments share one file)."""

    def __init__(self, path: str | os.PathLike, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"RunLog mode must be 'w' or 'a', got {mode!r}")
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        if mode == "w":
            open(self.path, "w").close()    # truncate
        # always O_APPEND: records written by append_event between session
        # writes must not be overwritten
        self._fh = open(self.path, "a")
        self._closed = False

    def write(self, event: str, **fields) -> dict:
        record = {"event": event, "t_wall": time.time(),
                  **_jsonable(fields)}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        return record

    def run_start(self, **fields) -> dict:
        return self.write("run_start", schema=SCHEMA_VERSION,
                          provenance=provenance(), **fields)

    def close(self) -> None:
        if not self._closed:
            self._fh.close()
            self._closed = True

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def append_event(path: str | os.PathLike, event: str, **fields) -> dict:
    """Append one structured record to a runlog outside any session."""
    record = {"event": event, "t_wall": time.time(), **_jsonable(fields)}
    parent = os.path.dirname(str(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(str(path), "a") as fh:
        fh.write(json.dumps(record) + "\n")
    return record


def read_runlog(path: str | os.PathLike,
                tolerant: bool = False) -> list[dict]:
    """Parse a runlog into record dicts; ``tolerant`` skips undecodable
    lines (a torn final line left by a crash mid-write)."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if not tolerant:
                    raise
    return records


def repair_tail(path: str | os.PathLike) -> bool:
    """Terminate a torn final line with a newline, so a later append does
    not fuse onto it; returns True when a repair was needed."""
    path = str(path)
    if not os.path.exists(path) or os.path.getsize(path) == 0:
        return False
    with open(path, "rb+") as fh:
        fh.seek(-1, os.SEEK_END)
        if fh.read(1) == b"\n":
            return False
        fh.write(b"\n")
    return True
