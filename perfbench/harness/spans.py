"""The program's host spans in a traced window (:class:`perfbench.harness.
trace.Trace`): which layer the host was in while the card sat idle, and
how long the host spent inside a span.

The engine opens a ``repro.*`` range at each layer boundary (``repro.run``,
``repro.chunk``, ``repro.step``, ``repro.skin_test``, ``repro.rebuild``,
``repro.integrate``, ``repro.refresh``, ``repro.force``, ``repro.observe``,
``repro.readback``) and a ``repro.sync`` range around each host read that
blocks on the card.  An idle gap of the card belongs to the innermost
layer span open on the main thread at the gap's midpoint, the rule
``Trace.breakdown`` labels gaps by.  ``repro.sync`` marks a read inside a
layer and is no layer itself, so a gap under it belongs to the span around
it.
"""
from __future__ import annotations

import collections

SYNC = "repro.sync"
STEP = "repro.step"
NO_SPAN = "(no span)"


def layered(trace) -> bool:
    """Whether the program opens the engine's layer spans: a ``repro.step``
    range in the window.  A program without them leaves the span metrics
    out."""
    return trace.range_counts.get(STEP, 0) > 0


def idle_by_span(trace) -> dict:
    """Idle seconds of the card by the innermost ``repro.*`` layer span
    open on the main thread at each gap's midpoint (:data:`NO_SPAN` where
    none is)."""
    spans = sorted((s, e, n) for s, e, n in trace.host
                   if n.startswith("repro.") and n != SYNC)
    gaps = sorted(trace.gaps(), key=lambda g: (g[0] + g[1]) // 2)
    idle = collections.Counter()
    stack, i = [], 0
    for s, e in gaps:
        mid = (s + e) // 2
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        stack = [h for h in stack if h[1] > mid]
        # the innermost: the latest start, and of two that start together
        # the one that ends first
        label = (max(stack, key=lambda h: (h[0], -h[1]))[2] if stack
                 else NO_SPAN)
        idle[label] += e - s
    return {k: v / 1e9 for k, v in idle.items()}


def idle_ms_per_step(ctx, names) -> float | None:
    """Idle ms a step under the layer spans ``names``; None without kernels
    or without the engine's layer spans."""
    tr = ctx["trace"]
    if tr is None or not tr.kernels() or not layered(tr):
        return None
    idle = idle_by_span(tr)
    return 1e3 * sum(idle.get(n, 0.0) for n in names) / ctx["window"][
        "steps"]


def host_s(trace, name: str) -> float:
    """Seconds the main thread spent inside the spans ``name``."""
    return sum(e - s for s, e, n in trace.host if n == name) / 1e9
