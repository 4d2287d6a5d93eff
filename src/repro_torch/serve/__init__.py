"""Simulation-as-a-service: a batched job engine in front of the Engine
(port of ``repro.serve``).

The paper's workload at service scale is not one giant run but a
firehose of small heterogeneous (T, B)-protocol jobs.  This package
turns the Engine's replica axis into a multi-tenant batch server: on the
card, the NEP-SPIN jobs of one bucket share one K1 and one K2 launch per
step.

* :mod:`repro_torch.serve.queue` - :class:`SimJob` requests and
  streaming :class:`JobHandle`\\ s (cancel, terminal states,
  quarantine);
* :mod:`repro_torch.serve.bucket` - shape-bucketing: jobs that may share
  one packed Engine map to one :class:`BucketKey`; :func:`job_digest` is
  the crash-recovery idempotency key (digests over array bytes);
* :mod:`repro_torch.serve.pack` - the packer: one per-slot Replicated
  Engine per bucket, continuous batching via slot backfill, supervised
  segments with poisoned-job eviction, deadline/backoff-requeue ladder;
* :mod:`repro_torch.serve.journal` - the durable job journal (WAL)
  behind :meth:`SimServer.recover`;
* :mod:`repro_torch.serve.accounting` - per-tenant accounting and
  admission control over the telemetry runlog (the single metrics path).

Entry point::

    cfg = ServeConfig(runlog="runs/serve.jsonl", workdir="runs/serve",
                      journal_dir="runs/serve/journal")
    server = SimServer(cfg)
    h = server.submit(SimJob(state=st, potential=pot, cfg=icfg,
                             masses=m, magnetic=mag, steps=100))
    server.drain()                  # or server.start() for a worker
    h.wait(); h.observables         # streamed rows, job clock

Crash recovery: after the process dies (SIGKILL included), rebuild with
``SimServer.recover(cfg)`` and resubmit the same requests - completed
jobs deduplicate against the journal, interrupted jobs re-seat from
their committed watermark, and the remaining streams are bitwise the
uninterrupted ones.  ``docs/serving.md`` describes the job API, the WAL
record schema and the operator runbook; the port keeps all three.

Where the port's contract differs from the reference's:

* **Builds.** The build watchdog counts kernel builds and library loads,
  once per process, so only the first bucket of a process can read
  warmup builds; the property is ``steady_compiles == 0`` everywhere.
* **Digests** are over the bytes of host copies of the arrays (the
  reference's ``potential_digest`` reads ``repr``, see
  :mod:`repro_torch.serve.bucket`).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading

import torch

from repro_torch.resilience.supervisor import SupervisorConfig
from repro_torch.serve.accounting import (Accounting, AdmissionError,
                                          TenantQuota)
from repro_torch.serve.bucket import BucketKey, bucket_key, job_digest
from repro_torch.serve.journal import (JobJournal, RecoveryState,
                                       replay_journal)
from repro_torch.serve.pack import BucketRuntime
from repro_torch.serve.queue import (CANCELLED, COMPLETED, DONE, EVICTED,
                                     FAILED, QUARANTINED, QUEUED, RUNNING,
                                     SHED, TERMINAL, JobHandle, JobQueue,
                                     RequeuePolicy, SimJob)
from repro_torch.telemetry import HealthConfig
from repro_torch.telemetry.runlog import append_event, repair_tail

__all__ = [
    "ServeConfig", "SimServer", "SimJob", "JobHandle", "JobQueue",
    "BucketKey", "bucket_key", "job_digest", "BucketRuntime",
    "Accounting", "AdmissionError", "TenantQuota", "RequeuePolicy",
    "JobJournal", "RecoveryState", "replay_journal", "validate_job",
    "QUEUED", "RUNNING", "QUARANTINED", "DONE", "COMPLETED", "FAILED",
    "EVICTED", "CANCELLED", "SHED", "TERMINAL",
]


def _default_supervisor() -> SupervisorConfig:
    # degrade_after=1: the first repeat of a failure class already tries
    # slot eviction (the serving rung); retries bound evictions per batch.
    # degrade_span=0 makes the dt rung inert: a packed batch must NEVER
    # integrate at a different dt - that would both rebuild the loop and
    # stream reduced-dt rows to every batch-mate, silently breaking
    # the packed-vs-solo parity contract.  A non-attributable persistent
    # failure therefore exhausts retries and fails the bucket instead.
    return SupervisorConfig(degrade_after=1, max_retries=3,
                            degrade_span=0)


@dataclasses.dataclass
class ServeConfig:
    """Server-wide configuration (per-job knobs live on :class:`SimJob`).

    ``chunk`` is the segment length: the batch advances in whole chunks
    and jobs are admitted only if ``obs_every`` divides it.  ``slots`` is
    the replica-axis width of every packed batch; ``schedule_knots`` the
    knot count K every job protocol is padded to (jobs with more knots
    are refused).  ``runlog`` is truncated at server construction - one
    file is the flight record AND the accounting ledger for the server's
    lifetime (``SimServer.recover`` appends instead).  ``quotas`` maps
    tenant name to :class:`TenantQuota`.

    Crash safety / backpressure: ``journal_dir`` enables the
    durable job journal (WAL) and per-bucket checkpointing; ``requeue``
    is the eviction/expiry retry ladder.  ``max_pending`` bounds live
    (non-terminal) jobs - beyond it the ``shed_policy`` decides who pays:
    ``"reject"`` refuses the newcomer, ``"priority"`` sheds the
    lowest-``tenant_priority`` queued job to make room.  Before shedding
    starts, ``overload_after`` pending jobs switch admission to overload
    mode: new jobs' ``obs_every`` is stretched by ``overload_obs_factor``
    (when divisibility allows) to cut streaming work per step.
    ``faults`` installs a :class:`~repro_torch.resilience.faults.FaultPlan` on
    every bucket engine - the chaos harness's entry point.
    """

    runlog: str
    workdir: str
    slots: int = 2
    chunk: int = 10
    schedule_knots: int = 8
    health: HealthConfig | None = dataclasses.field(
        default_factory=HealthConfig)
    supervised: bool = True
    supervisor: SupervisorConfig = dataclasses.field(
        default_factory=_default_supervisor)
    quotas: dict = dataclasses.field(default_factory=dict)
    journal_dir: str | None = None
    requeue: RequeuePolicy = dataclasses.field(
        default_factory=RequeuePolicy)
    max_pending: int | None = None
    shed_policy: str = "reject"         # "reject" | "priority"
    tenant_priority: dict = dataclasses.field(default_factory=dict)
    overload_after: int | None = None
    overload_obs_factor: int = 2
    faults: object | None = None        # FaultPlan (chaos harness)


def validate_job(job: SimJob, cfg: ServeConfig) -> None:
    """Admission checks that don't need a quota ledger; raises
    :class:`AdmissionError`.

    Deliberately does NOT inspect schedule values: a finite-state job
    with a poisoned protocol is admitted and handled at runtime by the
    health gate + supervisor eviction (the door checks the request is
    well-formed, the batch protects itself from what runs)."""
    if job.steps < 1:
        raise AdmissionError(f"steps must be >= 1, got {job.steps}")
    if job.obs_every < 1 or job.steps % job.obs_every:
        raise AdmissionError(
            f"steps ({job.steps}) must be a positive multiple of "
            f"obs_every ({job.obs_every})")
    if cfg.chunk % job.obs_every:
        raise AdmissionError(
            f"obs_every ({job.obs_every}) must divide the server chunk "
            f"({cfg.chunk})")
    pos = job.state.pos
    if pos.dim() != 2:
        raise AdmissionError(
            f"job state must be unbatched (N, 3), got pos "
            f"{tuple(pos.shape)}")
    # one device reduction and one host sync for the three leaves
    bad = torch.stack([(~torch.isfinite(getattr(job.state, name))).any()
                       for name in ("pos", "vel", "spin")]).tolist()
    for name, b in zip(("pos", "vel", "spin"), bad):
        if b:
            raise AdmissionError(f"non-finite values in state.{name}")
    for sched, label in ((job.temperature, "temperature"),
                         (job.field, "field")):
        knots = getattr(getattr(sched, "times", None), "shape", None)
        if knots is not None and int(knots[0]) > cfg.schedule_knots:
            raise AdmissionError(
                f"{label} schedule has {int(knots[0])} knots > server "
                f"limit {cfg.schedule_knots}")
    if not getattr(job.cfg, "frozen_lattice", False):
        raise AdmissionError(
            "serving requires frozen_lattice=True (spin dynamics on the "
            "crystalline reference): packed slots share one neighbor "
            "table, and lattice motion would couple rebuild timing "
            "across batch-mates, breaking the packed-vs-solo parity "
            "contract")
    if not hasattr(job.potential, "compute"):
        raise AdmissionError("potential needs the gather-once .compute() "
                             "surface")


class SimServer:
    """The batched simulation job server (see package doc).

    ``submit`` validates, meters, buckets, and enqueues a job, returning
    its :class:`JobHandle`.  ``drain()`` runs every bucket to completion
    on the calling thread (deterministic round-robin, one segment per
    bucket per pass); ``start()``/``stop()`` run the same loop on one
    background worker thread instead.  ``accounting`` replays the runlog
    into per-tenant totals at call time.
    """

    def __init__(self, cfg: ServeConfig, *, _fresh: bool = True):
        self.cfg = cfg
        os.makedirs(cfg.workdir, exist_ok=True)
        parent = os.path.dirname(str(cfg.runlog))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.journal = (JobJournal(cfg.journal_dir)
                        if cfg.journal_dir else None)
        if _fresh:
            open(cfg.runlog, "w").close()   # the ledger starts here
            if self.journal is not None:
                open(self.journal.path, "w").close()
                self.journal.write("journal_start", slots=cfg.slots,
                                   chunk=cfg.chunk,
                                   schedule_knots=cfg.schedule_knots)
        self.buckets: dict[BucketKey, BucketRuntime] = {}
        self.handles: list[JobHandle] = []
        self._ids = itertools.count()
        self._lock = threading.Lock()       # submit vs worker
        self._accepted: dict[str, dict] = {}   # tenant -> jobs/steps
        self._recovery: RecoveryState | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- crash recovery ------------------------------------------------
    @classmethod
    def recover(cls, cfg: ServeConfig) -> "SimServer":
        """Rebuild a server from its durable journal after a crash.

        Repairs crash-torn tails on both logs, replays the journal into
        a :class:`~repro_torch.serve.journal.RecoveryState`, neutralizes
        orphan runlog chunk records (segments computed after the last
        durable commit - see ``recovery_discard`` in accounting), and
        marks every known bucket for warmup re-classification.  The
        caller then RESUBMITS its requests: :meth:`submit` matches each
        on :func:`job_digest` - completed jobs come back instantly DONE
        (``recovered=True``, no recomputation, no double charge),
        interrupted jobs re-seat from their committed watermark, queued
        jobs re-queue in admission order."""
        if not cfg.journal_dir:
            raise ValueError("recover() needs cfg.journal_dir")
        repair_tail(os.path.join(cfg.journal_dir, "journal.jsonl"))
        if os.path.exists(cfg.runlog):
            repair_tail(cfg.runlog)
        state = replay_journal(cfg.journal_dir)
        srv = cls(cfg, _fresh=False)
        srv._recovery = state
        srv._ids = itertools.count(state.max_job_num + 1)
        srv._accepted = {t: dict(m) for t, m in state.accepted.items()}
        # neutralize computed-but-uncommitted slot-steps so the
        # charged+idle==computed invariant closes across incarnations
        if os.path.exists(cfg.runlog):
            acct = Accounting.from_runlog(cfg.runlog, tolerant=True)
            for bucket, slot_steps in sorted(acct.pending.items()):
                if slot_steps:
                    append_event(cfg.runlog, "recovery_discard",
                                 bucket=bucket, slot_steps=slot_steps)
        append_event(cfg.runlog, "recover",
                     buckets=sorted(b.bucket
                                    for b in state.buckets.values()))
        srv.journal.write("recovered",
                          jobs=len(state.jobs),
                          interrupted=[r.job_id
                                       for r in state.interrupted()],
                          queued=[r.job_id for r in state.queued()])
        return srv

    # ------------------------------------------------------------------
    def _check_quota(self, job: SimJob) -> None:
        quota = self.cfg.quotas.get(job.tenant)
        used = self._accepted.setdefault(job.tenant,
                                         {"jobs": 0, "steps": 0})
        if quota is None:
            return
        if (quota.max_jobs is not None
                and used["jobs"] + 1 > quota.max_jobs):
            raise AdmissionError(
                f"tenant {job.tenant!r} over job quota "
                f"({used['jobs']}/{quota.max_jobs})")
        if (quota.max_steps is not None
                and used["steps"] + job.steps > quota.max_steps):
            raise AdmissionError(
                f"tenant {job.tenant!r} over step quota "
                f"({used['steps']} + {job.steps} > {quota.max_steps})")

    # -- backpressure --------------------------------------------------
    def _pending(self) -> int:
        return sum(1 for h in self.handles if h.status not in TERMINAL)

    def _priority(self, tenant: str) -> float:
        return float(self.cfg.tenant_priority.get(tenant, 0.0))

    def _stretch_for_overload(self, job: SimJob, digest: str) -> SimJob:
        """Overload mode: stretch ``obs_every`` to shed streaming work
        before refusing jobs outright.  Identity (``digest``) is of the
        ORIGINAL request; the stretch is journaled in ``admitted``."""
        cfg = self.cfg
        if cfg.overload_after is None or cfg.overload_obs_factor <= 1:
            return job
        if self._pending() < cfg.overload_after:
            return job
        obs = job.obs_every * cfg.overload_obs_factor
        if job.steps % obs or cfg.chunk % obs:
            return job                   # stretch would break admission
        return dataclasses.replace(job, obs_every=obs)

    def _shed_for_admission(self, job: SimJob, digest: str) -> None:
        """Bounded-queue gate: raise (reject-newest) or evict a queued
        lower-priority victim (shed-lowest-tenant-priority)."""
        cfg = self.cfg
        if cfg.max_pending is None or self._pending() < cfg.max_pending:
            return
        if cfg.shed_policy == "priority":
            victim, vrt = None, None
            for rt in self.buckets.values():
                for h in rt.queue.peek_all():
                    if h.status != QUEUED:
                        continue
                    if victim is None or (self._priority(h.tenant)
                                          < self._priority(victim.tenant)):
                        victim, vrt = h, rt
            if (victim is not None
                    and self._priority(victim.tenant)
                    < self._priority(job.tenant)):
                vrt.queue.remove(victim)
                victim.finish(SHED, error="load shed: lower priority")
                self._refund(victim.job)
                append_event(self.cfg.runlog, "job_shed", job=victim.id,
                             tenant=victim.tenant, policy="priority")
                if self.journal is not None:
                    self.journal.write("shed", job=victim.id,
                                       digest=victim.digest,
                                       tenant=victim.tenant,
                                       policy="priority",
                                       tenant_refund=True)
                return
        if self.journal is not None:
            self.journal.write("shed", job=None, digest=digest,
                               tenant=job.tenant, policy="reject")
        raise AdmissionError(
            f"server over max_pending ({cfg.max_pending}): job rejected "
            f"(shed_policy={cfg.shed_policy!r})")

    def _refund(self, job: SimJob) -> None:
        used = self._accepted.get(job.tenant)
        if used is not None:
            used["jobs"] -= 1
            used["steps"] -= job.steps

    # -- recovery-aware admission --------------------------------------
    def _recovered_submit(self, job: SimJob, digest: str):
        """Match a resubmission against the replayed journal; returns a
        handle (dedup / re-seat / re-queue) or None for unknown jobs."""
        state = self._recovery
        rec = (state.jobs.get(digest) if state is not None else None)
        if rec is None:
            return None
        state.jobs.pop(digest)      # one lifecycle claim per recovery
        if rec.obs_every is not None and rec.obs_every != job.obs_every:
            job = dataclasses.replace(job, obs_every=rec.obs_every)
        if rec.status in ("completed", "deduplicated"):
            # already durably done in a previous incarnation: no
            # recomputation, no new charge (rows were streamed to the
            # previous incarnation's caller and are not replayable)
            handle = JobHandle(job, rec.job_id, digest=digest)
            handle.recovered = True
            handle.done_steps = rec.steps
            handle.finish(DONE)
            self.journal.write("deduplicated", job=rec.job_id,
                              digest=digest, tenant=rec.tenant)
            self.handles.append(handle)
            return handle
        if rec.status in ("failed", "cancelled", "shed"):
            return None                  # terminal non-success: fresh job
        key = bucket_key(job, self.cfg)
        handle = JobHandle(job, rec.job_id, bucket=key, digest=digest)
        handle.recovered = True
        rt = self.buckets.get(key)
        if rt is None:
            rt = self._new_bucket(key)
        seat = None
        b = state.buckets.get(key.id)
        if (b is not None and rec.slot is not None
                and b.slots.get(rec.slot) == digest
                and rec.watermark < rec.steps):
            seat = rec.slot
        if seat is not None and rt.adopt_handle(seat, handle):
            handle.done_steps = rec.watermark
            handle.rows_base = rec.watermark // job.obs_every
        else:
            rt.submit(handle)           # re-queue from step 0
        self.handles.append(handle)
        return handle

    def _new_bucket(self, key: BucketKey) -> BucketRuntime:
        """A bucket's runtime; after :meth:`recover` it adopts the bucket's
        journaled plan whichever job of the bucket is resubmitted first (a
        fresh job too), so the segment clock and the checkpoint tags go on
        from the last commit and interrupted jobs can still re-seat."""
        rt = self.buckets[key] = BucketRuntime(key, self.cfg,
                                               journal=self.journal)
        brec = (self._recovery.buckets.get(key.id)
                if self._recovery is not None else None)
        if brec is not None and brec.ckpt_step is not None:
            rt.adopt(brec)
        return rt

    # ------------------------------------------------------------------
    def submit(self, job: SimJob) -> JobHandle:
        """Admit one job: validate, meter, bucket, enqueue.

        With a journal, admission is idempotent on :func:`job_digest`:
        after :meth:`recover`, resubmitting a journaled request resumes
        (or deduplicates) its previous lifecycle instead of starting a
        new one."""
        validate_job(job, self.cfg)
        digest = job_digest(job) if self.journal is not None else None
        with self._lock:
            if digest is not None:
                handle = self._recovered_submit(job, digest)
                if handle is not None:
                    return handle
            self._check_quota(job)
            self._shed_for_admission(job, digest)
            if digest is not None:
                self.journal.write("submitted", digest=digest,
                                   tenant=job.tenant, steps=job.steps,
                                   name=job.name)
            job = self._stretch_for_overload(job, digest)
            validate_job(job, self.cfg)     # stretch kept it admissible
            key = bucket_key(job, self.cfg)
            handle = JobHandle(job, f"job-{next(self._ids):03d}",
                               bucket=key, digest=digest)
            used = self._accepted[job.tenant]
            used["jobs"] += 1
            used["steps"] += job.steps
            rt = self.buckets.get(key)
            if rt is None:
                rt = self._new_bucket(key)
            append_event(self.cfg.runlog, "job_submit", job=handle.id,
                         tenant=job.tenant, bucket=key.id,
                         steps=job.steps, name=job.name)
            if digest is not None:
                self.journal.write("admitted", job=handle.id,
                                   digest=digest, bucket=key.id,
                                   obs_every=job.obs_every)
            rt.submit(handle)
            self.handles.append(handle)
        return handle

    # ------------------------------------------------------------------
    def _tick(self) -> bool:
        """One round-robin pass: each bucket with work advances one
        segment.  Returns True if anything ran."""
        with self._lock:
            runtimes = list(self.buckets.values())
        worked = False
        for rt in runtimes:
            if rt.has_work():
                worked = rt.run_chunk() or worked
        return worked

    def drain(self) -> None:
        """Run every queued/packed job to completion (calling thread)."""
        if self._thread is not None:
            raise RuntimeError("drain() while a worker thread is running; "
                               "use handle.wait() instead")
        while self._tick():
            pass

    def start(self) -> None:
        """Start the single background worker (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self._tick():
                    self._stop.wait(0.02)

        self._thread = threading.Thread(target=loop, name="sim-serve",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the background worker (waits for the current segment)."""
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    # ------------------------------------------------------------------
    @property
    def accounting(self) -> Accounting:
        """Per-tenant / per-bucket totals replayed from the runlog."""
        return Accounting.from_runlog(self.cfg.runlog, tolerant=True)
