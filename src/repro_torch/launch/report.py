"""Render run reports from engine runlogs and serving journals (port of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report run.jsonl [more.jsonl]

A runlog is the JSONL event stream ``Engine.run(telemetry=...)`` writes:
the report gives the throughput, builds after the first chunk, the
energy-drift curve, the health verdicts, straggled chunks, every
resilience event (fault injection, rollback, retry, degradation, give-up;
one line each, the reference's), the serving server's lifecycle events
with the per-tenant accounting table, and the final status.  A serving
journal (``journal.jsonl``, :mod:`repro_torch.serve.journal`) renders as
a lifecycle report (:func:`journal_report`).

With no argument it prints the dry run's summary and roofline tables
(:func:`dryrun_main`) from ``experiments/dryrun/*.json``
(``python -m repro_torch.launch.dryrun --all`` writes them).
"""
from __future__ import annotations

import glob
import json
import math
import os
import sys

from repro_torch.ckpt.elastic import straggler_chunks

_BLOCKS = "▁▂▃▄▅▆▇█"

_RESIL_EVENTS = ("fault_injected", "rollback", "retry", "degrade",
                 "degrade_restore", "recovered", "give_up",
                 "elastic_restore", "evict")

# serve-layer lifecycle events (the chatty per-segment `serve_chunk`
# stream is summarized by the tenant table, not listed per event)
_SERVE_EVENTS = ("job_requeued", "job_expired", "job_cancelled",
                 "job_shed", "recover", "recovery_discard",
                 "bucket_failed")


def sparkline(values) -> str:
    """Unicode sparkline of a numeric series (non-finite entries -> 'x')."""
    vals = []
    for v in values:
        try:
            v = float(v)
        except (TypeError, ValueError):
            v = float("nan")
        vals.append(v)
    finite = [v for v in vals if math.isfinite(v)]
    if not finite:
        return "x" * len(vals)
    lo, hi = min(finite), max(finite)
    span = (hi - lo) or 1.0
    out = []
    for v in vals:
        if not math.isfinite(v):
            out.append("x")
        else:
            out.append(_BLOCKS[int((v - lo) / span * (len(_BLOCKS) - 1))])
    return "".join(out)


def _median(xs):
    xs = sorted(xs)
    if not xs:
        return None
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n:.0f} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _is_num(x) -> bool:
    try:
        float(x)
        return True
    except (TypeError, ValueError):
        return False


def _fmt_s(s) -> str:
    return f"{s:.2f} s" if isinstance(s, (int, float)) else "?"


def _fmt_resil(e: dict) -> str:
    """One report line per resilience event record."""
    ev = e.get("event")
    step = e.get("step", "?")
    if ev == "fault_injected":
        return (f"fault_injected: {e.get('kind')} at step "
                f"{e.get('fault_step', step)} (leaf {e.get('leaf')})")
    if ev == "rollback":
        return (f"rollback #{e.get('attempt', '?')}: {e.get('kind')} at "
                f"step {step} -> checkpoint {e.get('checkpoint')}")
    if ev == "retry":
        return (f"retry #{e.get('attempt', '?')}: resumed at step {step}, "
                f"{e.get('remaining', '?')} steps remaining")
    if ev == "degrade":
        if e.get("action") == "capacity":
            return (f"degrade: cell_capacity {e.get('prev_capacity')} -> "
                    f"{e.get('cell_capacity')} at step {step}")
        if e.get("action") == "dt":
            return (f"degrade: dt {e.get('prev_dt')} -> {e.get('dt')} for "
                    f"{e.get('span_steps')} steps at step {step}")
        return f"degrade: {e.get('kind')} at step {step} (no action)"
    if ev == "degrade_restore":
        return f"degrade_restore: dt back to {e.get('dt')} at step {step}"
    if ev == "evict":
        return (f"evict: job {e.get('job', '?')} (tenant "
                f"{e.get('tenant', '?')}) off slot {e.get('slot', '?')} "
                f"for {e.get('kind')} at step {step}")
    if ev == "recovered":
        return f"recovered after {e.get('attempts')} attempt(s) at step {step}"
    if ev == "give_up":
        return (f"give_up: {e.get('kind')} after {e.get('attempts')} "
                f"attempt(s) at step {step}")
    if ev == "elastic_restore":
        f_, t_ = e.get("from_layout", {}), e.get("to_layout", {})
        return (f"elastic_restore at step {step}: "
                f"{f_.get('devices', '?')} -> {t_.get('devices', '?')} "
                f"device(s), cells {f_.get('cells')} -> {t_.get('cells')}, "
                f"capacity {f_.get('cell_capacity')} -> "
                f"{t_.get('cell_capacity')}")
    return f"{ev}: {e}"


def _fmt_serve(e: dict) -> str:
    """One report line per serve-layer lifecycle event record."""
    ev = e.get("event")
    if ev == "job_requeued":
        return (f"job_requeued: {e.get('job', '?')} (tenant "
                f"{e.get('tenant', '?')}) attempt #{e.get('attempt', '?')} "
                f"on bucket {e.get('bucket', '?')}")
    if ev == "job_expired":
        tail = "requeued" if e.get("requeue") else "permanent"
        return (f"job_expired: {e.get('job', '?')} (tenant "
                f"{e.get('tenant', '?')}) hit its {e.get('kind', '?')} "
                f"budget ({tail})")
    if ev == "job_cancelled":
        return (f"job_cancelled: {e.get('job', '?')} (tenant "
                f"{e.get('tenant', '?')}) at a chunk boundary")
    if ev == "job_shed":
        return (f"job_shed: {e.get('job', '?')} (tenant "
                f"{e.get('tenant', '?')}) via {e.get('policy', '?')} policy")
    if ev == "recover":
        buckets = e.get("buckets") or []
        return (f"recover: journal replayed, {len(buckets)} bucket(s) "
                f"re-warmed ({', '.join(buckets) or '-'})")
    if ev == "recovery_discard":
        return (f"recovery_discard: {e.get('slot_steps', '?')} orphan "
                f"slot-steps on bucket {e.get('bucket', '?')} (computed "
                f"after the last durable commit, recomputed on replay)")
    if ev == "bucket_failed":
        return f"bucket_failed: {e.get('bucket', '?')} ({e.get('error')})"
    return f"{ev}: {e}"


def _tenant_table(path) -> list:
    """Per-tenant outcome summary table (accounting replay)."""
    from repro_torch.serve.accounting import Accounting

    acct = Accounting.from_runlog(path, tolerant=True)
    if not acct.tenants:
        return []
    lines = ["", "### Per-tenant outcomes", "",
             "| tenant | submitted | done | failed | evicted | requeued |"
             " expired | cancelled | shed | charged steps |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for name in sorted(acct.tenants):
        t = acct.tenants[name]
        lines.append(
            f"| {name} | {t['jobs_submitted']} | {t['jobs_done']} "
            f"| {t['jobs_failed']} | {t['jobs_evicted']} "
            f"| {t['jobs_requeued']} | {t['jobs_expired']} "
            f"| {t['jobs_cancelled']} | {t['jobs_shed']} "
            f"| {t['charged_steps']} |")
    lines.append("")
    inv = "closes exactly" if acct.consistent() else "**VIOLATED**"
    lines.append(
        f"accounting invariant (charged {acct.charged_steps} + idle "
        f"{acct.idle_steps} == computed {acct.computed_slot_steps}): {inv}")
    return lines


def journal_report(path: str | os.PathLike) -> str:
    """Render a serving journal (WAL) into a lifecycle report."""
    from repro_torch.telemetry.runlog import read_runlog

    events = read_runlog(path, tolerant=True)
    lines = [f"## Journal report: {path}", ""]
    counts: dict = {}
    tenants: dict = {}
    for e in events:
        ev = e.get("event")
        counts[ev] = counts.get(ev, 0) + 1
        if ev in ("completed", "failed", "cancelled", "shed",
                  "deduplicated") and e.get("tenant") is not None:
            t = tenants.setdefault(e["tenant"], {})
            t[ev] = t.get(ev, 0) + 1
    lines.append("- events: " + ", ".join(
        f"{n}x {k}" for k, n in sorted(counts.items())))
    commits = [e for e in events if e.get("event") == "commit"]
    if commits:
        last: dict = {}
        for c in commits:
            last[c.get("bucket")] = c
        for b in sorted(last):
            c = last[b]
            seats = c.get("slots") or {}
            lines.append(
                f"- bucket {b}: {c.get('segment', '?')} segment(s) "
                f"committed, ckpt step {c.get('ckpt_step', '?')}, "
                f"{len(seats)} seated job(s)")
    recov = [e for e in events if e.get("event") == "recovered"]
    for r in recov:
        lines.append(
            f"- recovered: {len(r.get('interrupted') or [])} re-seated, "
            f"{len(r.get('queued') or [])} re-queued of "
            f"{r.get('jobs', '?')} journaled job(s)")
    if tenants:
        lines.append("- terminal outcomes by tenant: " + "; ".join(
            f"{t}: " + ", ".join(f"{n}x {k}" for k, n in sorted(v.items()))
            for t, v in sorted(tenants.items())))
    return "\n".join(lines)


def _is_journal(path) -> bool:
    if os.path.basename(str(path)) == "journal.jsonl":
        return True
    try:
        with open(path) as fh:
            first = fh.readline()
        return ('"journal_start"' in first or '"submitted"' in first)
    except OSError:
        return False


def runlog_report(path: str | os.PathLike) -> str:
    """Render one runlog into a human-readable report string."""
    from repro_torch.telemetry.runlog import read_runlog

    events = read_runlog(path, tolerant=True)
    start = next((e for e in events if e.get("event") == "run_start"), {})
    # a supervised run appends retry segments to one file: the LAST
    # run_end is the final word, chunk records span all segments
    end = next((e for e in reversed(events)
                if e.get("event") == "run_end"), None)
    chunks = [e for e in events if e.get("event") == "chunk"]
    segments = sum(1 for e in events if e.get("event") == "run_start")
    resil = [e for e in events if e.get("event") in _RESIL_EVENTS]
    serve = [e for e in events if e.get("event") in _SERVE_EVENTS]

    lines = [f"## Run report: {path}", ""]
    prov = start.get("provenance", {})
    card = prov.get("nvidia_smi") or prov.get("device_name") or "no card"
    lines.append(
        f"- plan `{start.get('plan', '?')}` | potential "
        f"`{start.get('potential', '?')}` | {start.get('n_atoms', '?')} atoms"
        f" | `{start.get('device', '?')}` ({card}; torch "
        f"{prov.get('torch_version', '?')}, CUDA "
        f"{prov.get('cuda_version', '?')})")
    lines.append(
        f"- schedule: {start.get('n_steps', '?')} steps in chunks of "
        f"{start.get('chunk', '?')} (dt {start.get('dt_ps', '?')} ps)")

    if not chunks:
        lines.append("- no chunk records (run failed before first boundary)")
    else:
        rates = [c["steps_per_s"] for c in chunks
                 if _is_num(c.get("steps_per_s"))]
        # steady state: skip the first chunk (kernel builds and loads)
        steady = [c["steps_per_s"] for c in chunks[1:]
                  if _is_num(c.get("steps_per_s"))] or rates
        if rates:
            lines.append(
                f"- throughput: median {_median(rates):.1f} steps/s "
                f"(steady-state {_median(steady):.1f} steps/s over "
                f"{len(chunks)} chunk(s))")
        compiles = [c.get("compiles", 0) for c in chunks]
        post_warm = sum(compiles[1:])
        lines.append(
            f"- kernel builds and loads: {compiles[0]} warmup, {post_warm} "
            "after warmup" + ("  <-- RECOMPILE" if post_warm else ""))
        drifts = [c.get("health", {}).get("e_drift") for c in chunks]
        if any(d is not None for d in drifts):
            worst = max((abs(float(d)) for d in drifts
                         if d is not None and _is_num(d)
                         and math.isfinite(float(d))), default=None)
            lines.append(
                f"- energy drift per chunk: {sparkline(drifts)} "
                f"(max |drift| {worst:.3e})" if worst is not None
                else f"- energy drift per chunk: {sparkline(drifts)}")
        verdicts = {}
        for c in chunks:
            v = c.get("verdict", "?")
            verdicts[v] = verdicts.get(v, 0) + 1
        lines.append("- health: " + ", ".join(
            f"{n}x {v}" for v, n in sorted(verdicts.items())))
        walls = [c.get("wall_s") for c in chunks]
        if all(_is_num(w) for w in walls) and len(walls) >= 2:
            slow = straggler_chunks(walls)
            if slow:
                lines.append(
                    f"- stragglers: {len(slow)} chunk(s) over 1.5x the "
                    f"trailing median wall time: "
                    + ", ".join(f"#{i} ({walls[i]:.2f}s)" for i in slow))

    if resil:
        counts = {}
        for e in resil:
            counts[e["event"]] = counts.get(e["event"], 0) + 1
        lines.append("- resilience: " + ", ".join(
            f"{n}x {k}" for k, n in sorted(counts.items()))
            + (f" across {segments} run segment(s)" if segments > 1 else ""))
        for e in resil:
            lines.append("  " + _fmt_resil(e))

    if serve:
        counts = {}
        for e in serve:
            counts[e["event"]] = counts.get(e["event"], 0) + 1
        lines.append("- serving: " + ", ".join(
            f"{n}x {k}" for k, n in sorted(counts.items())))
        for e in serve:
            lines.append("  " + _fmt_serve(e))
        lines.extend(_tenant_table(path))

    if end is None:
        lines.append("- status: **incomplete** (no run_end record)")
    else:
        status = end.get("status", "?")
        mark = "" if status == "ok" else " **<-- FAILED**"
        lines.append(
            f"- status: {status}{mark} | {end.get('total_steps', '?')} steps "
            f"in {_fmt_s(end.get('total_wall_s'))}")
        if end.get("error"):
            lines.append(f"  error: {end['error']}")
        if end.get("peak_memory_bytes"):
            lines.append(
                f"- peak device memory: "
                f"{_fmt_bytes(end['peak_memory_bytes'])}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# dry-run / roofline tables
# ---------------------------------------------------------------------------


def load_all(d="experiments/dryrun"):
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_e(x):
    return f"{x:.2e}" if x is not None else "-"


def roofline_table(recs, pod="pod1") -> str:
    lines = [
        "| arch | shape | compute [s] | memory [s] | collective [s] | "
        "bound | MODEL/HLO | hbm args [GB/dev] |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        tag_pod = "pod2" if r["mesh"].get("pod") else "pod1"
        if tag_pod != pod:
            continue
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                         f"SKIP | - | - |")
            continue
        if "error" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | - | - | - | "
                         f"ERROR | - | - |")
            continue
        rf = r["roofline"]
        mem = r.get("memory", {})
        args_gb = (mem.get("argument_bytes") or 0) / 1e9
        ratio = rf.get("useful_flops_ratio")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.2e} | "
            f"{rf['memory_s']:.2e} | {rf['collective_s']:.2e} | "
            f"**{rf['bottleneck']}** | "
            f"{(f'{ratio:.2f}' if ratio else '-')} | {args_gb:.2f} |")
    return "\n".join(lines)


def summary(recs) -> str:
    ok = [r for r in recs if "roofline" in r]
    skip = [r for r in recs if "skipped" in r]
    err = [r for r in recs if "error" in r]
    out = [f"cells: {len(ok)} compiled OK, {len(skip)} skipped "
           f"(documented), {len(err)} errors"]
    if ok:
        worst = min(
            (r for r in ok if r["meta"].get("kind") == "train"),
            key=lambda r: (r["roofline"]["compute_s"] /
                           max(r["roofline"]["step_time_s"], 1e-30)),
            default=None)
        if worst:
            out.append(
                f"worst compute-fraction train cell: {worst['arch']} "
                f"{worst['shape']}")
        coll = max(ok, key=lambda r: r["roofline"]["collective_s"])
        out.append(f"most collective-bound: {coll['arch']} {coll['shape']} "
                   f"({coll['roofline']['collective_s']:.2e}s)")
    return "\n".join(out)


def dryrun_main(d="experiments/dryrun"):
    recs = load_all(d)
    print("## Dry-run + roofline summary\n")
    print(summary(recs))
    print("\n### Single-pod (16x16 = 256 cards)\n")
    print(roofline_table(recs, "pod1"))
    print("\n### Multi-pod (2x16x16 = 512 cards)\n")
    print(roofline_table(recs, "pod2"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        dryrun_main()
        return
    for i, path in enumerate(argv):
        if i:
            print()
        if _is_journal(path):
            print(journal_report(path))
        else:
            print(runlog_report(path))


if __name__ == "__main__":
    main()
