"""The port's runlog report (``repro_torch.launch.report``) against the
reference's (``repro.launch.report``): on the resilience records of
``tests/test_resilience.py``'s report test, the port renders every token
and exactly the reference's resilience lines; on a real supervised runlog
of the port it renders each event; the parts that wait for later items
name them.
"""
import pytest

from repro_torch.launch import report
from repro_torch.telemetry.runlog import append_event
from torch_one_thread import one_torch_thread  # noqa: F401

TOKENS = ("fault_injected: nan", "rollback #1", "retry #1",
          "cell_capacity 16 -> 32", "dt 0.002 -> 0.001", "degrade_restore",
          "elastic_restore at step 20", "2 -> 1 device", "recovered after 2",
          "give_up: nonfinite")


def _write_records(log):
    """The records of tests/test_resilience.py's report test."""
    append_event(log, "run_start", schema=1, plan="sharded")
    append_event(log, "fault_injected", kind="nan", fault_step=5,
                 chunk_step=0, leaf="spin", device=0)
    append_event(log, "rollback", kind="nonfinite", attempt=1, step=10,
                 chunk_index=0, signals={}, checkpoint="ck", error="x")
    append_event(log, "degrade", kind="overflow", action="capacity",
                 cell_capacity=32, prev_capacity=16, step=10)
    append_event(log, "degrade", kind="nonfinite", action="dt", dt=1e-3,
                 prev_dt=2e-3, span_steps=20, step=10)
    append_event(log, "degrade_restore", kind="nonfinite", dt=2e-3, step=30)
    append_event(log, "retry", attempt=1, kind="nonfinite", step=10,
                 remaining=30)
    append_event(log, "elastic_restore", step=20,
                 from_layout={"devices": 2, "cells": [4, 2, 2],
                              "cell_capacity": 16},
                 to_layout={"devices": 1, "cells": [2, 2, 2],
                            "cell_capacity": 32}, checkpoint="ck")
    append_event(log, "recovered", attempts=2, step=40)
    append_event(log, "give_up", kind="nonfinite", attempts=5, step=10)
    append_event(log, "evict", kind="nonfinite", job="j3", tenant="t1",
                 slot=2, step=12)


@pytest.fixture
def log(tmp_path):
    path = str(tmp_path / "r.jsonl")
    _write_records(path)
    return path


def _resil_lines(text):
    lines = text.splitlines()
    i = next(i for i, ln in enumerate(lines) if ln.startswith(
        "- resilience:"))
    out = [lines[i]]
    for ln in lines[i + 1:]:
        if not ln.startswith("  "):
            break
        out.append(ln)
    return out


def test_report_renders_every_resilience_token(log):
    text = report.runlog_report(log)
    for token in TOKENS:
        assert token in text, (token, text)
    assert "evict: job j3 (tenant t1) off slot 2 for nonfinite" in text


def test_resilience_lines_are_the_references(log):
    """The summary line and one line per record, character for character
    the reference's report of the same file."""
    from repro.launch.report import runlog_report as ref_report
    ours, theirs = _resil_lines(report.runlog_report(log)), _resil_lines(
        ref_report(log))
    assert len(ours) == 11           # the summary and 10 records
    assert ours == theirs


def test_report_of_a_supervised_run(tmp_path):
    """A supervised NaN recovery of the port's engine, end to end: header,
    throughput, builds, drift curve (the failed chunk's NaN drift as 'x'),
    health verdicts, every resilience event, the final status."""
    from repro_torch.launch.resilience_smoke import (STEPS, CHUNK,
                                                     make_engine)
    from repro_torch.resilience import (Fault, FaultPlan, Supervisor,
                                        install_faults)
    from repro_torch.telemetry import HealthConfig, Telemetry
    import torch
    path = str(tmp_path / "run.jsonl")
    eng = make_engine("cpu")
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=25, leaf="force"),)), runlog=path)
    Supervisor().run(eng, STEPS, torch.Generator().manual_seed(0),
                     chunk=CHUNK, checkpoint_dir=str(tmp_path / "ck"),
                     telemetry=Telemetry(runlog=path, health=HealthConfig()))
    text = report.runlog_report(path)
    for token in ("plan `SingleDevice`", "potential `HeisenbergDMIModel`",
                  "64 atoms", f"{STEPS} steps in chunks of {CHUNK}",
                  "throughput: median", "kernel builds and loads: 0 warmup, "
                  "0 after warmup", "energy drift per chunk:",
                  "health: 1x fail, 4x ok",
                  "1x fault_injected, 1x recovered, 1x retry, 1x rollback "
                  "across 2 run segment(s)",
                  "fault_injected: nan at step 25 (leaf force)",
                  "rollback #1: nonfinite at step 30", "retry #1: resumed "
                  "at step 20, 20 steps remaining",
                  "recovered after 1 attempt(s) at step 40", "status: ok"):
        assert token in text, (token, text)
    drift = next(ln for ln in text.splitlines() if "energy drift" in ln)
    assert "x" in drift.split(":")[1].split("(")[0]


def test_report_helpers():
    assert report.sparkline([0, 1, 2, float("nan")]) == "▁▄█x"
    assert report.sparkline(["a", None]) == "xx"
    assert report.straggler_chunks([9.0, 1.0, 1.0, 1.0, 1.0, 3.0]) == [5]
    assert report.straggler_chunks([1.0, 1.0]) == []
    assert report._fmt_bytes(3 * 1024 ** 3) == "3.0 GiB"


def test_incomplete_and_failed_runs(tmp_path):
    path = str(tmp_path / "r.jsonl")
    append_event(path, "run_start", schema=1, plan="SingleDevice")
    assert "run failed before first boundary" in report.runlog_report(path)
    assert "**incomplete**" in report.runlog_report(path)
    append_event(path, "run_end", status="failed", total_steps=0,
                 total_wall_s=0.5, error="boom")
    text = report.runlog_report(path)
    assert "FAILED" in text and "error: boom" in text


def test_later_items_name_themselves(tmp_path, capsys, monkeypatch):
    # item 12 (serve/) is in: a journal renders through main() as a
    # lifecycle report (tests/test_torch_serve_reference.py holds it line
    # for line against the reference's); item 14 too: with no argument
    # main() prints the dry run's summary and tables (none written here)
    from repro_torch.serve.journal import JobJournal
    journal = JobJournal(str(tmp_path / "wal"))
    journal.write("journal_start", slots=2, chunk=10, schedule_knots=8)
    journal.write("commit", bucket="b0", segment=1, ckpt_step=10, slots={})
    report.main([journal.path])
    assert "- bucket b0: 1 segment(s) committed, ckpt step 10" in \
        capsys.readouterr().out
    monkeypatch.chdir(tmp_path)
    report.main([])
    out = capsys.readouterr().out
    assert "cells: 0 compiled OK, 0 skipped (documented), 0 errors" in out
    assert "### Multi-pod (2x16x16 = 512 cards)" in out
    path = str(tmp_path / "r.jsonl")
    _write_records(path)
    report.main([path])
    assert "give_up: nonfinite" in capsys.readouterr().out
