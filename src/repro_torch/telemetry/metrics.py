"""Run metrics: counters/gauges registry and the compile watchdog (port of
``repro.telemetry.metrics``).

:class:`RunMetrics` holds monotonic counters (steps, rebuilds, compiles)
and last-value gauges (steps/s, peak device memory); the runlog persists
snapshots of it.

:class:`CompileWatchdog` counts what recompiling means in the port: kernel
libraries compiled by ``nvcc`` and loaded by :mod:`repro_torch._build`.
The port captures no CUDA graphs and calls no ``torch.compile``, so there
is nothing else to count.  Run-scoped accounting uses marks: ``mark()``,
then ``since(mark)``.  A steady-state run reads 0 after its first chunk.

:class:`HostSyncCounter` reads the host syncs that
:func:`repro_torch.telemetry.profiling.host_sync` counts (each one a
``repro.sync`` range), by the same marks.
"""
from __future__ import annotations

import dataclasses

import torch


class CompileWatchdog:
    """Process-wide kernel build + library load counter with run-scoped
    delta reads."""

    @property
    def count(self) -> int:
        from repro_torch import _build
        return _build.EVENTS["builds"] + _build.EVENTS["loads"]

    def mark(self) -> int:
        """Take a mark; pass it to :meth:`since` for a run-scoped delta."""
        return self.count

    def since(self, mark: int) -> int:
        return self.count - mark


class HostSyncCounter:
    """Process-wide count of the host reads that block on the card, with
    run-scoped delta reads."""

    @property
    def count(self) -> int:
        from repro_torch.telemetry.profiling import HOST_SYNCS
        return HOST_SYNCS.count

    def mark(self) -> int:
        """Take a mark; pass it to :meth:`since` for a run-scoped delta."""
        return self.count

    def since(self, mark: int) -> int:
        return self.count - mark


@dataclasses.dataclass
class RunMetrics:
    """Counters (monotonic, ``inc``) and gauges (last value, ``set``)."""

    counters: dict = dataclasses.field(default_factory=dict)
    gauges: dict = dataclasses.field(default_factory=dict)

    def inc(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def set(self, name: str, value) -> None:
        self.gauges[name] = value

    def snapshot(self) -> dict:
        return {"counters": dict(self.counters), "gauges": dict(self.gauges)}


def peak_device_memory() -> int | None:
    """Peak bytes allocated by torch on the current card since the last
    ``torch.cuda.reset_peak_memory_stats``, or None without a card."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.max_memory_allocated())
