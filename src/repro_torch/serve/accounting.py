"""Per-tenant accounting and admission control over the telemetry runlog
(port of ``repro.serve.accounting``).

The serving layer does NOT invent a second metrics path: the single
source of truth for what was computed is the engine's runlog
(:mod:`repro_torch.telemetry.runlog`).  The engine writes one ``chunk``
record per chunk (steps, wall seconds, kernel builds and library loads,
health verdict) and a ``run_start`` header tagged with the bucket id
(``Engine.run_tags``), and the packer appends one
``serve_chunk`` event per segment mapping replica slots to the jobs and
tenants that occupied them.  :class:`Accounting` replays that stream and
produces per-tenant and per-bucket totals, with one auditable invariant:

    sum(tenant charged slot-steps) + idle slot-steps
        == sum(ok/warn-verdict chunk steps x replicas)

which holds exactly even through supervisor rollback-retries (failed
chunks are excluded, replayed chunks count once) and slot evictions (an
evicted job is charged for the segments it actually occupied).  Chunks
integrated inside a dt-degradation span are excluded, as in the
reference; a server's supervisor disables the dt rung
(``_default_supervisor``: ``degrade_span=0``), so its runlog holds none.

Admission control (:class:`TenantQuota`) gates ``SimServer.submit``:
requested integration steps are debited against a per-tenant budget
before the job is queued, so a noisy tenant is refused at the door
instead of starving batch-mates.
"""
from __future__ import annotations

import dataclasses

from repro_torch.telemetry.runlog import read_runlog


class AdmissionError(Exception):
    """A job was refused at submit time (malformed or over quota)."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission limits for one tenant (None = unlimited)."""

    max_jobs: int | None = None    # concurrent + completed jobs accepted
    max_steps: int | None = None   # total requested integration steps


def _tenant_zero() -> dict:
    return {"jobs_submitted": 0, "jobs_done": 0, "jobs_failed": 0,
            "jobs_evicted": 0, "jobs_shed": 0, "jobs_requeued": 0,
            "jobs_expired": 0, "jobs_cancelled": 0,
            "requested_steps": 0, "charged_steps": 0, "wall_s": 0.0}


def _bucket_zero() -> dict:
    return {"chunks": 0, "warmup_compiles": 0, "steady_compiles": 0,
            "ok_slot_steps": 0, "failed_chunks": 0, "wall_s": 0.0,
            "replicas": 0}


class Accounting:
    """Replay a serving runlog into per-tenant / per-bucket totals.

    Build with :meth:`from_runlog` (the normal path) or feed records
    one-by-one with :meth:`feed` for streaming use.  ``tenants`` and
    ``buckets`` are plain dicts of counters; :meth:`consistent` checks
    the charged-vs-computed invariant (module doc) and
    :meth:`summary` returns everything JSON-able.
    """

    def __init__(self):
        self.tenants: dict[str, dict] = {}
        self.buckets: dict[str, dict] = {}
        self.idle_steps = 0
        self.evictions: list[dict] = []
        self.sheds: list[dict] = []
        self.requeues: list[dict] = []
        self.recoveries = 0
        # ok slot-steps accrued since each bucket's last serve_chunk: the
        # crash-orphan window (computed but never charged nor idled).
        # SimServer.recover turns a nonzero tail into `recovery_discard`
        # events so the invariant closes across incarnations.
        self.pending: dict[str, int] = {}
        self._bucket = None        # current run_start's bucket tag
        self._replicas = 0
        self._in_degrade_span = False
        self._rewarm: set = set()  # buckets whose next chunk is a warmup

    # ------------------------------------------------------------------
    def _tenant(self, name) -> dict:
        return self.tenants.setdefault(str(name), _tenant_zero())

    def _bucket_of(self, name) -> dict:
        return self.buckets.setdefault(str(name), _bucket_zero())

    # ------------------------------------------------------------------
    def feed(self, rec: dict) -> None:
        """Consume one runlog record (chunk record or serve event)."""
        ev = rec.get("event")
        if ev == "run_start":
            self._bucket = rec.get("bucket")
            self._replicas = int(rec.get("replicas") or 0) or 1
            if self._bucket is not None:
                self._bucket_of(self._bucket)["replicas"] = self._replicas
        elif ev == "chunk" and self._bucket is not None:
            b = self._bucket_of(self._bucket)
            b["chunks"] += 1
            compiles = int(rec.get("compiles") or 0)
            if b["chunks"] == 1 or self._bucket in self._rewarm:
                # a recovered incarnation may load kernels once per
                # bucket: its first post-recover chunk is warmup, like
                # bucket birth (the port builds and loads a kernel library
                # once per process, so a later bucket's warmup reads 0)
                b["warmup_compiles"] += compiles
                self._rewarm.discard(self._bucket)
            else:
                b["steady_compiles"] += compiles
            if rec.get("verdict") == "fail":
                b["failed_chunks"] += 1
            elif self._in_degrade_span:
                pass   # a dt span: the reference charges nobody for it
            else:
                slot_steps = int(rec["steps"]) * self._replicas
                b["ok_slot_steps"] += slot_steps
                b["wall_s"] += float(rec.get("wall_s") or 0.0)
                self.pending[self._bucket] = (
                    self.pending.get(self._bucket, 0) + slot_steps)
        elif ev == "degrade" and rec.get("action") == "dt":
            self._in_degrade_span = True
        elif ev == "degrade_restore":
            self._in_degrade_span = False
        elif ev == "serve_chunk":
            steps = int(rec["steps"])
            occupied = rec.get("slots") or {}
            for info in occupied.values():
                t = self._tenant(info["tenant"])
                t["charged_steps"] += steps
                t["wall_s"] += (float(rec.get("wall_s") or 0.0)
                                / max(len(occupied), 1))
            self.idle_steps += steps * len(rec.get("idle") or ())
            if rec.get("bucket") is not None:
                self.pending[str(rec["bucket"])] = 0   # segment committed
        elif ev == "recovery_discard":
            # crash-orphan neutralization: slot-steps computed after the
            # last committed segment were never streamed or charged; the
            # recovered server recomputes them from the rollback point
            b = self._bucket_of(rec["bucket"])
            slot_steps = int(rec["slot_steps"])
            b["ok_slot_steps"] -= slot_steps
            left = self.pending.get(str(rec["bucket"]), 0) - slot_steps
            self.pending[str(rec["bucket"])] = max(left, 0)
        elif ev == "recover":
            self.recoveries += 1
            self._rewarm = set(map(str, rec.get("buckets") or ()))
        elif ev == "job_submit":
            t = self._tenant(rec["tenant"])
            t["jobs_submitted"] += 1
            t["requested_steps"] += int(rec.get("steps") or 0)
        elif ev == "job_done":
            self._tenant(rec["tenant"])["jobs_done"] += 1
        elif ev == "job_failed":
            self._tenant(rec["tenant"])["jobs_failed"] += 1
        elif ev == "evict":
            if rec.get("tenant") is not None:
                self._tenant(rec["tenant"])["jobs_evicted"] += 1
            self.evictions.append(rec)
        elif ev == "job_shed":
            self._tenant(rec["tenant"])["jobs_shed"] += 1
            self.sheds.append(rec)
        elif ev == "job_requeued":
            self._tenant(rec["tenant"])["jobs_requeued"] += 1
            self.requeues.append(rec)
        elif ev == "job_expired":
            self._tenant(rec["tenant"])["jobs_expired"] += 1
        elif ev == "job_cancelled":
            self._tenant(rec["tenant"])["jobs_cancelled"] += 1

    @classmethod
    def from_runlog(cls, path, tolerant: bool = False) -> "Accounting":
        """Replay a whole serving runlog file.  ``tolerant=True`` skips a
        crash-torn final line (crash recovery replays what committed)."""
        acct = cls()
        for rec in read_runlog(path, tolerant=tolerant):
            acct.feed(rec)
        return acct

    # ------------------------------------------------------------------
    @property
    def charged_steps(self) -> int:
        return sum(t["charged_steps"] for t in self.tenants.values())

    @property
    def computed_slot_steps(self) -> int:
        return sum(b["ok_slot_steps"] for b in self.buckets.values())

    def consistent(self) -> bool:
        """Charged + idle slot-steps exactly cover the computed ones."""
        return (self.charged_steps + self.idle_steps
                == self.computed_slot_steps)

    def summary(self) -> dict:
        return {"tenants": self.tenants, "buckets": self.buckets,
                "idle_steps": self.idle_steps,
                "charged_steps": self.charged_steps,
                "computed_slot_steps": self.computed_slot_steps,
                "evictions": len(self.evictions),
                "sheds": len(self.sheds),
                "requeues": len(self.requeues),
                "recoveries": self.recoveries,
                "consistent": self.consistent()}
