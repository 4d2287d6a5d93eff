"""Durable job journal: the serving tier's write-ahead log (port of
``repro.serve.journal``; the record schema is the reference's).

One append-only JSONL file (``<journal_dir>/journal.jsonl``, the
``telemetry/runlog.py`` append machinery) records every job-lifecycle
transition the server performs: ``submitted`` / ``admitted`` at the
door, ``seated`` / ``backfilled`` when a job enters a replica slot,
one ``commit`` per bucket segment carrying each seated job's step
watermark plus the bucket's newest checkpoint ref, ``evicted`` /
``requeued`` through the quarantine ladder, and a terminal
``completed`` / ``failed`` / ``cancelled`` / ``shed``.

The journal is the RECOVERY source of truth; the runlog stays the
ACCOUNTING source of truth.  Neither duplicates the other: the journal
records what each job *is owed* (identity digest, watermark, seat),
the runlog what each tenant *was charged*.  ``SimServer.recover``
replays the journal with :func:`replay_journal` and reconstructs queue
order, bucket occupancy, and per-job watermarks; resubmitting the same
request (same :func:`repro_torch.serve.bucket.job_digest`) then maps onto the
journaled lifecycle instead of starting over - completed work is
deduplicated, interrupted work re-seats from its watermark via
``Engine.restore``: the checkpointed carry and the slots' generators.

Two crash-window subtleties the replay is built around:

* **Orphan checkpoints.** The engine saves its chunk checkpoint BEFORE
  the packer journals the ``commit``, so a crash between the two leaves
  a checkpoint one segment AHEAD of the durable watermark.  Recovery
  restores at the *journaled* ``ckpt_step`` (validated against
  ``ckpt.available_steps``), never blindly at the newest - the orphan
  segment's rows were never streamed and must be recomputed.
* **Torn tails.** SIGKILL mid-append leaves a partial final line;
  ``telemetry.runlog.repair_tail`` quarantines it and the tolerant
  reader skips it.  Every record before the tear is intact (writes are
  flushed per record).
"""
from __future__ import annotations

import dataclasses
import os

from repro_torch.telemetry.runlog import append_event, read_runlog, repair_tail

JOURNAL_FILE = "journal.jsonl"

# journal events that end a job's lifecycle (replay: nothing to recover)
_TERMINAL_EVENTS = ("completed", "failed", "cancelled", "shed",
                    "deduplicated")


class JobJournal:
    """Append-side handle on one serving journal (crash-durable)."""

    def __init__(self, journal_dir: str):
        self.dir = str(journal_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, JOURNAL_FILE)

    def write(self, event: str, **fields) -> dict:
        return append_event(self.path, event, **fields)

    def exists(self) -> bool:
        return os.path.exists(self.path)


@dataclasses.dataclass
class JobRecord:
    """Replayed lifecycle of one journaled job."""

    digest: str
    job_id: str
    tenant: str = "default"
    steps: int = 0
    obs_every: int | None = None    # effective (possibly stretched)
    bucket: str | None = None
    slot: int | None = None         # seat at last commit (else None)
    watermark: int = 0              # durably committed steps
    status: str = "queued"          # queued|running|<terminal>
    attempts: int = 0
    order: int = 0                  # admission order (requeue keeps it)


@dataclasses.dataclass
class BucketRecord:
    """Replayed recovery plan of one bucket: where to restore."""

    bucket: str
    ckpt_step: int | None = None    # last committed checkpoint ref
    segment: int = 0                # segments committed so far
    slots: dict = dataclasses.field(default_factory=dict)  # slot->digest


@dataclasses.dataclass
class RecoveryState:
    """Everything :meth:`SimServer.recover` needs, replayed from the WAL."""

    jobs: dict = dataclasses.field(default_factory=dict)    # digest->JobRecord
    buckets: dict = dataclasses.field(default_factory=dict) # id->BucketRecord
    max_job_num: int = -1           # highest job-NNN seen (id continuation)
    accepted: dict = dataclasses.field(default_factory=dict)  # tenant->meter

    def interrupted(self) -> list:
        """Jobs to re-seat from their watermark (still held a slot at
        their bucket's last commit, with steps left)."""
        out = []
        for rec in self.jobs.values():
            if rec.status in _TERMINAL_EVENTS:
                continue
            b = self.buckets.get(rec.bucket)
            if (b is not None and b.ckpt_step is not None
                    and rec.slot is not None
                    and b.slots.get(rec.slot) == rec.digest
                    and rec.watermark < rec.steps):
                out.append(rec)
        return out

    def queued(self) -> list:
        """Jobs to re-queue from scratch, in admission order (everything
        non-terminal that has no committed seat to resume)."""
        seats = {r.digest for r in self.interrupted()}
        out = [r for r in self.jobs.values()
               if r.status not in _TERMINAL_EVENTS and r.digest not in seats]
        return sorted(out, key=lambda r: r.order)


def _job_num(job_id: str) -> int:
    try:
        return int(str(job_id).rsplit("-", 1)[-1])
    except (ValueError, IndexError):
        return -1


def replay_journal(journal_dir: str) -> RecoveryState:
    """Reconstruct serving state from the WAL (tolerant of a torn tail)."""
    path = os.path.join(str(journal_dir), JOURNAL_FILE)
    state = RecoveryState()
    if not os.path.exists(path):
        return state
    repair_tail(path)
    order = 0
    for rec in read_runlog(path, tolerant=True):
        ev = rec.get("event")
        if ev == "submitted":
            digest = rec["digest"]
            jr = state.jobs.get(digest)
            if jr is None or jr.status in _TERMINAL_EVENTS:
                # a resubmitted digest after a terminal verdict is a NEW
                # lifecycle (shed/cancelled jobs may legitimately retry)
                jr = state.jobs[digest] = JobRecord(
                    digest=digest, job_id=rec.get("job", ""),
                    tenant=rec.get("tenant", "default"),
                    steps=int(rec.get("steps") or 0), order=order)
            order += 1
        elif ev == "admitted":
            jr = state.jobs.get(rec.get("digest"))
            if jr is not None:
                jr.job_id = rec.get("job", jr.job_id)
                jr.bucket = rec.get("bucket", jr.bucket)
                if rec.get("obs_every") is not None:
                    jr.obs_every = int(rec["obs_every"])
                state.max_job_num = max(state.max_job_num,
                                        _job_num(jr.job_id))
                meter = state.accepted.setdefault(
                    jr.tenant, {"jobs": 0, "steps": 0})
                meter["jobs"] += 1
                meter["steps"] += jr.steps
        elif ev in ("seated", "backfilled"):
            jr = state.jobs.get(rec.get("digest"))
            if jr is not None:
                jr.status = "running"
                jr.slot = int(rec["slot"])
                jr.bucket = rec.get("bucket", jr.bucket)
                jr.attempts += 1
        elif ev == "commit":
            bid = rec["bucket"]
            b = state.buckets.setdefault(bid, BucketRecord(bucket=bid))
            b.ckpt_step = int(rec["ckpt_step"])
            b.segment = int(rec["segment"])
            b.slots = {}
            for slot, info in (rec.get("slots") or {}).items():
                b.slots[int(slot)] = info["digest"]
                jr = state.jobs.get(info["digest"])
                if jr is not None:
                    jr.watermark = int(info["done"])
                    jr.slot = int(slot)
                    jr.bucket = bid
        elif ev == "evicted":
            jr = state.jobs.get(rec.get("digest"))
            if jr is not None:
                jr.status = "queued"
                jr.slot = None
        elif ev == "requeued":
            jr = state.jobs.get(rec.get("digest"))
            if jr is not None:
                jr.status = "queued"
                jr.slot = None
                jr.watermark = 0    # requeue restarts from step 0
        elif ev in _TERMINAL_EVENTS:
            jr = state.jobs.get(rec.get("digest"))
            if jr is not None:
                jr.status = ev
                if rec.get("tenant_refund"):
                    meter = state.accepted.get(jr.tenant)
                    if meter is not None:
                        meter["jobs"] -= 1
                        meter["steps"] -= jr.steps
    return state
