"""Profiler hooks: phase scopes, host annotations, Chrome trace dumps (port
of ``repro.telemetry.profiling``).

* :func:`phase` names a step phase (``repro.force``, ``repro.rebuild``,
  ``repro.integrate``, ``repro.observe``): a ``torch.profiler``
  ``record_function`` range, plus an NVTX range when a card is present,
  so ``torch.profiler`` traces and NVTX-aware tools attribute the kernels
  launched inside it.  Outside a profiler the cost is a few microseconds
  on the host per scope.
* :func:`annotate` is the same for host-side regions: the engine's
  ``repro.run``, ``repro.chunk``, ``repro.step``, ``repro.skin_test``,
  ``repro.refresh`` and ``repro.readback``, and ``repro.halo.<tag>``
  around each halo exchange of the Sharded plan.
* :func:`host_sync` marks one host read that blocks on the card (an
  ``.item()``, a ``.cpu()``, a boolean-mask index, a blocking copy to the
  card): a ``repro.sync`` range, and one count of the process-wide
  :data:`HOST_SYNCS`, which :class:`repro_torch.telemetry.metrics.
  HostSyncCounter` reads by mark and delta.  The count and the ranges are
  one thing, counted here.
* :func:`maybe_trace` wraps a run in ``torch.profiler.profile`` when given
  a directory and writes a Chrome trace (``trace.json``) there; a
  profiler that cannot start raises, since the trace was asked for.
"""
from __future__ import annotations

import contextlib
import functools
import os

import torch


@functools.cache
def _nvtx() -> bool:
    """Whether NVTX ranges are pushed: a card is present (read once)."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def annotate(name: str):
    """Profiler range ``name`` (and an NVTX range on a card)."""
    nvtx = _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def phase(name: str):
    """Scope of one step phase, named ``repro.<name>``."""
    return annotate(f"repro.{name}")


class _HostSyncs:
    """The process's host syncs: ``count`` scopes opened so far, ``open``
    scopes open now."""

    count = 0
    open = 0


HOST_SYNCS = _HostSyncs()


@contextlib.contextmanager
def host_sync():
    """Scope of one host read that blocks on the card: a ``repro.sync``
    range, counted in :data:`HOST_SYNCS`."""
    HOST_SYNCS.count += 1
    HOST_SYNCS.open += 1
    try:
        with annotate("repro.sync"):
            yield
    finally:
        HOST_SYNCS.open -= 1


@contextlib.contextmanager
def maybe_trace(profile_dir: str | os.PathLike | None):
    """Write a Chrome trace of the enclosed run to ``profile_dir``
    (opt-in; ``None`` is a no-op)."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts, acc_events=True)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(str(profile_dir),
                                              "trace.json"))
