"""The traced window: ``torch.profiler`` over the measured chunks, reduced to
what the metric readers take.

Every device operation of the window (kernels, copies, fills) comes from
the profiler's CUPTI records; the copies of host ranges that the profiler
also lays on the device's timeline (a name that a host event has) are no
operations and are left out.  A kernel is attributed to the ``repro.*``
ranges (the program's ``record_function`` scopes) that were open on the
launching host thread when it was launched: its launch call is found
through the correlation id, and the ranges are looked up by time on that
thread.  The window is the ``perfbench.window`` range the harness opens
around the measured chunks.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

WINDOW = "perfbench.window"
RANGES = ("repro.force", "repro.rebuild", "repro.integrate", "repro.observe")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int          # ns, the profiler's clock
    dur: int            # ns
    kind: str           # "kernel" | "memory"
    ranges: frozenset   # the repro.* ranges open at its launch


@dataclasses.dataclass
class Trace:
    window_start: int
    window_end: int
    ops: list
    range_counts: dict      # repro.* name -> ranges opened in the window
    host: list              # (start, end, name) of host ops, main thread

    @property
    def window_s(self) -> float:
        return (self.window_end - self.window_start) / 1e9

    def kernels(self):
        return [o for o in self.ops if o.kind == "kernel"]

    def device_s(self, pred=lambda op: True) -> float:
        """Seconds of the kernels for which ``pred`` holds."""
        return sum(o.dur for o in self.ops
                   if o.kind == "kernel" and pred(o)) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        iv = sorted((o.start, o.start + o.dur) for o in self.ops)
        busy, cur_s, cur_e = 0, None, None
        for s, e in iv:
            s, e = max(s, self.window_start), min(e, self.window_end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def gaps(self):
        """Idle intervals of the device inside the window."""
        iv = sorted((o.start, o.start + o.dur) for o in self.ops)
        t, out = self.window_start, []
        for s, e in iv:
            if s > t:
                out.append((t, min(s, self.window_end)))
            t = max(t, e)
            if t >= self.window_end:
                break
        if t < self.window_end:
            out.append((t, self.window_end))
        return [(s, e) for s, e in out if e > s]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the innermost host op open at each gap's
        midpoint), in seconds."""
        by_name = collections.Counter()
        for o in self.ops:
            by_name[o.name[:160]] += o.dur
        gaps = sorted(self.gaps(), key=lambda g: (g[0] + g[1]) // 2)
        host = sorted(self.host)
        idle = collections.Counter()
        stack, i = [], 0
        for s, e in gaps:
            mid = (s + e) // 2
            while i < len(host) and host[i][0] <= mid:
                stack.append(host[i])
                i += 1
            stack = [h for h in stack if h[1] > mid]
            label = (max(stack, key=lambda h: h[0])[2] if stack
                     else "(no host op)")
            idle[label[:160]] += e - s
        return {"device_ops": [[k, v / 1e9]
                               for k, v in by_name.most_common(top)],
                "idle_gaps": [[k, v / 1e9] for k, v in idle.most_common(top)]}


@contextlib.contextmanager
def traced():
    """Profile the enclosed block; yields a holder whose ``trace`` is set
    on exit (:class:`Trace`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    holder = type("TraceHolder", (), {"trace": None})()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    with prof:
        with record_function(WINDOW):
            yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    holder.trace = reduce(prof.profiler.kineto_results.events())


def reduce(events) -> Trace:
    """:class:`Trace` from the profiler's raw events."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    host_ev, dev_ev = [], []
    for e in events:
        (dev_ev if e.device_type() == cuda else host_ev).append(e)
    win = [e for e in host_ev if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w = win[0]
    w0, w1, main = w.start_ns(), w.start_ns() + w.duration_ns(), \
        w.start_thread_id()
    by_corr, ranges = {}, collections.defaultdict(list)
    host = []
    counts = collections.Counter()
    for e in host_ev:
        name = e.name()
        by_corr.setdefault(e.correlation_id(), e)
        if name.startswith("repro."):
            ranges[(e.start_thread_id(), name)].append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
            if w0 <= e.start_ns() < w1:
                counts[name] += 1
        if e.start_thread_id() == main and name != WINDOW and \
                w0 <= e.start_ns() < w1:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    index = {}
    for key, iv in ranges.items():
        iv.sort()
        index[key] = ([s for s, _ in iv], [x for _, x in iv])
    host_names = {e.name() for e in host_ev}
    ops = []
    for e in dev_ev:
        name = e.name()
        if name in host_names:
            continue     # a host range's copy on the device's timeline
                         # (repro.*, the window, nccl:all_gather, ...)
        start = e.start_ns()
        if not (w0 <= start < w1):
            continue
        kind = ("memory" if name.startswith(("Memcpy", "Memset", "memcpy",
                                             "memset")) else "kernel")
        launch = None
        for cid in (e.linked_correlation_id(), e.correlation_id()):
            r = by_corr.get(cid)
            if r is not None and r.device_type() != cuda:
                launch = r
                break
        open_ = set()
        if launch is not None:
            t, tid = launch.start_ns(), launch.start_thread_id()
            for rname in RANGES:
                iv = index.get((tid, rname))
                if iv is None:
                    continue
                i = bisect.bisect_right(iv[0], t) - 1
                if i >= 0 and iv[1][i] >= t:
                    open_.add(rname)
        ops.append(DeviceOp(name, start, e.duration_ns(), kind,
                            frozenset(open_)))
    return Trace(w0, w1, ops, dict(counts), host)
