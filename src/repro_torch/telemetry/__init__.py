"""Run-scoped observability for the port's MD engine (port of
``repro.telemetry``).

* :mod:`.metrics` - :class:`RunMetrics`, the :class:`CompileWatchdog`
  (kernel builds and library loads) and the :class:`HostSyncCounter`;
* :mod:`.monitor` - health signals, chunk-boundary thresholds and the
  structured :class:`HealthError` naming the last-good checkpoint;
* :mod:`.profiling` - ``repro.<phase>`` profiler / NVTX ranges, the
  counted ``repro.sync`` scope and an opt-in Chrome trace;
* :mod:`.runlog` - the per-chunk JSONL event stream.

Entry point::

    tel = Telemetry(runlog="runs/anneal.jsonl",
                    health=HealthConfig(max_spin_dev=1e-3))
    engine.run(n_steps, generator, chunk=100, telemetry=tel)

or ``engine.run(..., telemetry="runs/anneal.jsonl")``.
"""
from __future__ import annotations

import dataclasses
import os
import time

from repro_torch.telemetry.metrics import (CompileWatchdog, HostSyncCounter,
                                           RunMetrics, peak_device_memory)
from repro_torch.telemetry.monitor import (HealthConfig, HealthError,
                                           check_chunk, nonfinite_count,
                                           occupancy_fraction, spin_norm_dev)
from repro_torch.telemetry.profiling import (annotate, host_sync,
                                             maybe_trace, phase)
from repro_torch.telemetry.runlog import (RunLog, append_event, read_runlog,
                                          repair_tail)

__all__ = [
    "Telemetry", "TelemetrySession", "RunMetrics", "CompileWatchdog",
    "HostSyncCounter", "host_sync",
    "HealthConfig", "HealthError", "RunLog", "read_runlog", "append_event",
    "repair_tail", "check_chunk", "nonfinite_count", "occupancy_fraction",
    "spin_norm_dev", "phase", "annotate", "maybe_trace",
    "peak_device_memory", "as_telemetry",
]


@dataclasses.dataclass
class Telemetry:
    """Run observability config for ``Engine.run(telemetry=...)``: the
    JSONL ``runlog``, the ``health`` thresholds checked at every chunk
    boundary (``None`` disables the checks; the signals still land in
    ``engine.trace.health``), an optional Chrome-trace ``profile_dir``,
    and ``append`` to continue an existing runlog."""

    runlog: str | os.PathLike | None = None
    health: HealthConfig | None = dataclasses.field(
        default_factory=HealthConfig)
    profile_dir: str | os.PathLike | None = None
    metrics: RunMetrics = dataclasses.field(default_factory=RunMetrics)
    append: bool = False


def as_telemetry(telemetry) -> "Telemetry | None":
    """Normalize ``None | path | Telemetry`` to a Telemetry object."""
    if telemetry is None or isinstance(telemetry, Telemetry):
        return telemetry
    if isinstance(telemetry, (str, os.PathLike)):
        return Telemetry(runlog=telemetry)
    raise TypeError(f"telemetry must be a path or Telemetry, got "
                    f"{type(telemetry).__name__}")


def _halo_totals(ledger) -> dict:
    return {"counts": dict(ledger.counts), "bytes": dict(ledger.bytes)} \
        if ledger is not None else {}


class TelemetrySession:
    """One run's telemetry: wall clocks, compile and host-sync deltas,
    runlog records.
    The engine calls :meth:`chunk` at every chunk boundary and
    :meth:`finish` once."""

    def __init__(self, tel: Telemetry, *, run_info: dict, ledger=None):
        self.tel = tel
        # the halo ledger (Sharded plan): each chunk record gets the
        # exchanges of its chunk, {"counts", "bytes"} by tag
        self.ledger = ledger
        self._halo_mark = _halo_totals(ledger)
        self.metrics = tel.metrics
        self.watchdog = CompileWatchdog()
        self._compile_mark = self.watchdog.mark()
        self.syncs = HostSyncCounter()
        self._sync_start = self._sync_mark = self.syncs.mark()
        self._t0 = time.perf_counter()
        self._steps = 0
        self._chunks = 0
        self.runlog = (RunLog(tel.runlog, mode="a" if tel.append else "w")
                       if tel.runlog else None)
        if self.runlog is not None:
            self.runlog.run_start(**run_info)

    def chunk(self, *, steps: int, step: int, time_ps: float, wall_s: float,
              health: dict, verdict: str, counters: dict | None = None,
              error: str | None = None) -> dict:
        """Record one chunk boundary; returns the runlog record."""
        compiles = self.watchdog.since(self._compile_mark)
        self._compile_mark = self.watchdog.mark()
        host_syncs = self.syncs.since(self._sync_mark)
        self._sync_mark = self.syncs.mark()
        self._steps += steps
        self._chunks += 1
        steps_per_s = steps / wall_s if wall_s > 0 else float("inf")
        self.metrics.inc("steps", steps)
        self.metrics.inc("chunks")
        self.metrics.inc("compiles", compiles)
        self.metrics.inc("host_syncs", host_syncs)
        self.metrics.inc("wall_s", wall_s)
        for name, value in (counters or {}).items():
            self.metrics.inc(name, value)
        self.metrics.set("steps_per_s", steps_per_s)
        record = {
            "chunk": self._chunks - 1, "steps": steps, "step": step,
            "time_ps": time_ps, "wall_s": wall_s, "steps_per_s": steps_per_s,
            "compiles": compiles, "host_syncs": host_syncs,
            "health": health, "verdict": verdict,
            **(counters or {}),
        }
        if self.ledger is not None:
            now = _halo_totals(self.ledger)
            record["halo"] = {
                k: {t: v - self._halo_mark[k].get(t, 0)
                    for t, v in now[k].items()} for k in now}
            self._halo_mark = now
        if error is not None:
            record["error"] = error
        if self.runlog is not None:
            self.runlog.write("chunk", **record)
        return record

    def finish(self, status: str = "ok", **extra) -> dict | None:
        wall = time.perf_counter() - self._t0
        self.metrics.set("total_wall_s", wall)
        peak = peak_device_memory()
        if peak is not None:
            self.metrics.set("peak_memory_bytes", peak)
        record = None
        if self.runlog is not None:
            record = self.runlog.write(
                "run_end", status=status, total_steps=self._steps,
                total_chunks=self._chunks, total_wall_s=wall,
                host_syncs=self.syncs.since(self._sync_start),
                steps_per_s=(self._steps / wall if wall > 0 else None),
                peak_memory_bytes=peak, metrics=self.metrics.snapshot(),
                **extra)
            self.runlog.close()
        return record
