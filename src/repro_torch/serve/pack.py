"""The packer: same-bucket jobs laid onto one Engine's replica axis (port of
``repro.serve.pack``).

One :class:`BucketRuntime` owns one per-slot Replicated Engine
(``Engine(plan=Replicated(slots), per_slot=True)``) and drives it in
fixed ``chunk``-step segments.  Between segments it backfills freed
replica slots from the bucket's FIFO queue (``Engine.write_slots`` -
batch-mates keep their exact bits), streams each job's observable rows
to its handle, and appends one ``serve_chunk`` accounting event to the
runlog.  On the card a NEP-SPIN bucket runs one K1 and one K2 launch per
evaluation for all its slots.

Determinism contract: a job's trajectory is bitwise the trajectory the
same job gets from a single-slot server.  Three mechanisms carry it:

* per-slot generators - each slot draws its thermostat noise from its
  own ``torch.Generator`` seeded with the job's ``seed`` (an idle slot's
  with 0); a generator advances in place, so a slot's stream never
  depends on its batch-mates or slot index, and a backfill swaps the
  slot's generator in the list the next segment runs with;
* per-slot clocks and schedule rows - each slot's ``states.step`` starts
  at the job's own 0 and its (T, B) protocol lives in one row of a
  :class:`~repro_torch.ensemble.protocol.SlotSchedules` stack (host
  numpy arrays), evaluated at the slot's own elapsed time;
* a shared neighbor table that all slots of a bucket agree on by
  construction (the bucket key digests the geometry bytes; serving
  admits frozen lattices only, so the table is built once).

Failure isolation: segments run under the Supervisor, and the engine's
``evict_slot_hook`` (installed here) turns the degradation rung into an
eviction - the failing chunk's per-slot health signals pin the fault on
one slot (:func:`repro_torch.resilience.supervisor.attribute_slot`),
that job is retired (see below) with its protocol neutralized, and the
batch replays the segment from the rollback checkpoint, carry and
generators, bitwise, without it.  Only when no slot can be blamed (or
retries run out) does the whole bucket fail.

Retirement ladder: an evicted or deadline-expired job is not necessarily
terminal.  Under a :class:`~repro_torch.serve.queue.RequeuePolicy` with
retry budget it is QUARANTINED for an exponential backoff
(:func:`repro_torch.resilience.supervisor.backoff_delay`) and then
re-queued from step 0; ``max_strikes`` consecutive same-class failures
(keyed on ``HealthError.kind``, the supervisor's own ladder currency)
classify it permanently - EVICTED for health kinds, FAILED for
deadline/timeout.  Deadlines (``SimJob.deadline_steps`` on the bucket
clock since admission, ``SimJob.timeout_s`` on the wall since submit) and
caller cancellation are enforced at chunk boundaries.

Crash safety: with a :class:`~repro_torch.serve.journal.JobJournal`
attached, every seat / backfill / retirement is journaled, and each
segment ends with a ``commit`` record carrying the seated jobs' step
watermarks and the bucket's newest checkpoint ref.  Checkpoint step tags
are rebased onto the monotonic bucket clock (``Engine.ckpt_step_offset``;
slot 0's own clock resets on backfill) so refs never move backwards.
``SimServer.recover`` replays the journal and hands the bucket an
adoption plan; :meth:`BucketRuntime._resume_engine` rebuilds the packed
engine and restores the journaled checkpoint with the generators it
holds, after which the surviving jobs' remaining streams are bitwise the
uninterrupted ones.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import available_steps
from repro_torch.ensemble import protocol
from repro_torch.md.engine import Engine
from repro_torch.md.state import SpinLatticeState, stack_states
from repro_torch.parallel.plan import Replicated
from repro_torch.resilience.faults import install_faults
from repro_torch.resilience.supervisor import (Strikes, Supervisor,
                                               attribute_slot, backoff_delay)
from repro_torch.serve.queue import (CANCELLED, DONE, EVICTED, FAILED,
                                     TERMINAL, JobQueue)
from repro_torch.telemetry import HealthError, Telemetry
from repro_torch.telemetry.runlog import append_event

_EXPIRY_KINDS = ("deadline", "timeout")


def _is_sched(x) -> bool:
    return (hasattr(x, "at") and hasattr(x, "times")
            and hasattr(x, "values"))


def _host32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _on_device(device):
    """The job's card as the current device of the calling thread (the
    server's background worker drives the card from its own thread)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _slot_state(states: SpinLatticeState, slot: int) -> SpinLatticeState:
    """Slot ``slot`` of a batch as a flat state of its own tensors."""
    return SpinLatticeState(
        *(getattr(states, k)[slot].clone()
          for k in ("pos", "vel", "spin", "types", "box")),
        step=int(states.step[slot]))


class BucketRuntime:
    """One shape bucket's packed batch (see module doc).

    Created lazily by ``SimServer`` per
    :class:`~repro_torch.serve.bucket.BucketKey`; ``submit`` enqueues a
    handle, ``run_chunk`` advances the batch one segment (seating queued
    jobs into free slots first) and returns whether any work was done.
    """

    def __init__(self, key, cfg, journal=None):
        self.key = key
        self.cfg = cfg
        self.journal = journal              # JobJournal | None
        self.queue = JobQueue()
        self.quarantine = []                # handles in backoff
        self.engine: Engine | None = None
        self.handles = [None] * key.slots
        self.gens = None                    # one torch.Generator per slot
        self.tsched = None                  # SlotSchedules (R, K)
        self.fsched = None                  # SlotSchedules (R, K, 3)
        self.failed = False
        self.segments = 0
        self.backfills = 0                  # write_slots calls
        self.supervisor = (Supervisor(cfg.supervisor, runlog=cfg.runlog)
                           if cfg.supervised else None)
        self._ckpt_dir = os.path.join(cfg.workdir, f"bucket-{key.id}")
        self._recovery = None               # BucketRecord adoption plan
        self._adopted: dict = {}            # slot -> handle (pre-resume)

    # ------------------------------------------------------------------
    def _jlog(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.write(event, bucket=self.key.id, **fields)

    def submit(self, handle) -> None:
        handle.enqueued_at_steps = self.segments * self.key.chunk
        self.queue.push(handle)

    def has_work(self) -> bool:
        return not self.failed and (
            len(self.queue) > 0
            or bool(self._adopted)
            or any(h is not None for h in self.handles)
            or any(h.status not in TERMINAL for h in self.quarantine))

    # -- recovery adoption ---------------------------------------------
    def adopt(self, plan) -> None:
        """Accept a journal-replayed :class:`BucketRecord`: continue the
        segment clock and (until the engine starts) hold the re-seat map
        open for resubmitted interrupted jobs."""
        self._recovery = plan
        self.segments = int(plan.segment)

    def adopt_handle(self, slot: int, handle) -> bool:
        """Claim a recovered seat for a resubmitted job.  Returns False
        when the plan is gone (engine already resumed, or the checkpoint
        ref is not on disk) - the caller re-queues from scratch."""
        if self.engine is not None or self._recovery is None:
            return False
        if self._recovery.slots.get(slot) != handle.digest:
            return False
        if self._recovery.ckpt_step not in available_steps(self._ckpt_dir):
            return False
        self._adopted[slot] = handle
        return True

    def _resume_engine(self) -> None:
        """Rebuild the packed engine from the journaled recovery plan and
        restore the committed checkpoint (carry and the slots'
        generators)."""
        plan, self._recovery = self._recovery, None
        adopted, self._adopted = self._adopted, {}
        job0 = next(iter(adopted.values())).job
        states, tlist, flist = [], [], []
        for i in range(self.key.slots):
            h = adopted.get(i)
            if h is not None:
                states.append(h.job.state)      # shape template only:
                ts, fs = self._job_schedules(h.job)  # restore overwrites
            else:
                states.append(job0.state)
                ts, fs = self._idle_schedules()
            tlist.append(ts)
            flist.append(fs)
        self.tsched = protocol.stack_schedules(tlist, k=self.key.knots)
        self.fsched = protocol.stack_schedules(flist, k=self.key.knots)
        with _on_device(job0.state.pos.device):
            eng = self._build_engine(job0, stack_states(states))
            self.gens = eng.restore(self._ckpt_dir, step=plan.ckpt_step)
        self.engine = eng
        for i, h in adopted.items():
            self.handles[i] = h
            h.attempts = max(h.attempts, 1)
            h.mark_running()
            self._jlog("seated", job=h.id, digest=h.digest, slot=i,
                       segment=self.segments, recovered=True)

    # -- schedule rows -------------------------------------------------
    def _job_schedules(self, job):
        """Normalize a job's (T, B) protocol to two padded Schedules on
        the job's own clock (every job goes through the SAME
        normalization, packed or solo - part of the parity contract)."""
        t = job.temperature
        if t is None:
            t = getattr(job.cfg, "temperature", 0.0)
        ts = t if _is_sched(t) else protocol.constant(float(t))
        f = job.field
        if f is None:
            f = np.zeros((3,), np.float32)
        fs = f if _is_sched(f) else protocol.constant(_host32(f))
        k = self.key.knots
        return protocol.pad_schedule(ts, k), protocol.pad_schedule(fs, k)

    def _idle_schedules(self):
        """Idle slots integrate at T=0, B=0 (their rows are discarded)."""
        k = self.key.knots
        return (protocol.pad_schedule(protocol.constant(0.0), k),
                protocol.pad_schedule(
                    protocol.constant(np.zeros((3,), np.float32)), k))

    def _set_slot_protocol(self, slot, ts, fs) -> None:
        """Write one slot's rows into the host schedule stacks the engine
        reads at every chunk start (values only: same (R, K) shapes)."""
        self.tsched.times[slot] = ts.times
        self.tsched.values[slot] = ts.values
        self.fsched.times[slot] = fs.times
        self.fsched.values[slot] = fs.values
        if self.engine is not None:
            self.engine.temperature = self.tsched
            self.engine.field = self.fsched

    # -- quarantine / expiry -------------------------------------------
    def _requeue_ready(self) -> None:
        """Move quarantined jobs whose backoff elapsed back to the queue
        (from step 0 - their slot state died with the eviction)."""
        now = time.time()
        still = []
        for h in self.quarantine:
            if h.status in TERMINAL:        # cancelled while parked
                continue
            if h._ready_t > now:
                still.append(h)
                continue
            h.reset_progress()
            if not h.requeue():
                continue
            h.enqueued_at_steps = self.segments * self.key.chunk
            self.queue.push(h)
            append_event(self.cfg.runlog, "job_requeued", job=h.id,
                         tenant=h.tenant, bucket=self.key.id,
                         attempt=h.attempts + 1)
            self._jlog("requeued", job=h.id, digest=h.digest,
                       tenant=h.tenant, attempt=h.attempts + 1)
        self.quarantine = still

    def _expired_kind(self, h) -> str | None:
        """Which budget (if any) the job has exhausted at this boundary."""
        job = h.job
        if (job.timeout_s is not None
                and time.time() - h.submitted_t > job.timeout_s):
            return "timeout"
        if job.deadline_steps is not None:
            elapsed = self.segments * self.key.chunk - h.enqueued_at_steps
            if elapsed >= job.deadline_steps:
                return "deadline"
        return None

    def _retire(self, h, slot: int | None, kind: str, error: str) -> str:
        """Retirement ladder for an evicted/expired job: quarantine with
        backoff while budget lasts, else classify permanently.  Returns
        the disposition ("requeue" | "evicted" | "failed" | "cancelled")."""
        policy = self.cfg.requeue
        strikes = h.__dict__.setdefault("_strikes", Strikes())
        count = strikes.hit(kind)
        self._jlog("evicted", job=h.id, digest=h.digest, slot=slot,
                   tenant=h.tenant, kind=kind)
        if h.cancel_requested:
            h.finish(CANCELLED, error=error)
            append_event(self.cfg.runlog, "job_cancelled", job=h.id,
                         tenant=h.tenant, bucket=self.key.id)
            self._jlog("cancelled", job=h.id, digest=h.digest,
                       tenant=h.tenant)
            return "cancelled"
        # a wall timeout is monotone - requeueing cannot un-expire it -
        # so it is always permanent; a deadline window resets on requeue
        permanent = (kind == "timeout"
                     or h.attempts > policy.retries
                     or count >= policy.max_strikes)
        if kind in _EXPIRY_KINDS:
            append_event(self.cfg.runlog, "job_expired", job=h.id,
                         tenant=h.tenant, bucket=self.key.id, kind=kind,
                         requeue=not permanent)
        if permanent:
            status = FAILED if kind in _EXPIRY_KINDS else EVICTED
            h.finish(status, error=error)
            self._jlog("failed", job=h.id, digest=h.digest, tenant=h.tenant,
                       status=status, kind=kind)
            return status
        delay = backoff_delay(h.attempts, policy.backoff_s)
        h.quarantine(time.time() + delay, error=error)
        self.quarantine.append(h)
        return "requeue"

    # -- seating -------------------------------------------------------
    def _pop_seatable(self):
        """Next queued handle that is still alive and inside its budgets
        (queued-cancelled handles are skipped; already-expired ones are
        retired without ever occupying a slot)."""
        while True:
            h = self.queue.pop()
            if h is None:
                return None
            if h.status in TERMINAL:
                continue
            kind = self._expired_kind(h)
            if kind is not None:
                self._retire(h, None, kind,
                             f"expired ({kind}) before seating")
                continue
            return h

    def _seat(self) -> None:
        """Fill free slots from the queue (engine start or backfill)."""
        if self.failed:
            return
        self._requeue_ready()
        if self.engine is None and (self._recovery is not None
                                    and self._adopted):
            self._resume_engine()
        if self.engine is None:
            if not len(self.queue):
                return
            for i in range(self.key.slots):
                h = self._pop_seatable()
                if h is None:
                    break
                self._install(i, h, event="seated")
            if any(h is not None for h in self.handles):
                self._start_engine()
            return
        for i in range(self.key.slots):
            if self.handles[i] is not None or not len(self.queue):
                continue
            h = self._pop_seatable()
            if h is None:
                continue
            self._install(i, h, event="backfilled")
            self._backfill(i, h)

    def _install(self, slot: int, h, event: str) -> None:
        self.handles[slot] = h
        h.attempts += 1
        h.mark_running()
        self._jlog(event, job=h.id, digest=h.digest, slot=slot,
                   segment=self.segments)

    def _build_engine(self, job0, states) -> Engine:
        """The bucket's packed Engine, on the card the jobs' states live
        on."""
        dev = states.pos.device
        eng = Engine(
            potential=job0.potential, cfg=job0.cfg,
            state=states,
            masses=torch.as_tensor(job0.masses, dtype=states.pos.dtype,
                                   device=dev),
            magnetic=torch.as_tensor(job0.magnetic, dtype=torch.bool,
                                     device=dev),
            cutoff=self.key.cutoff, capacity=self.key.capacity,
            skin=self.key.skin, plan=Replicated(self.key.slots),
            # the linked-cell build where the box fits its 27-cell stencil
            # (the dense build otherwise, as the reference's engine
            # default): a card-scale bucket of 262,144 atoms cannot take
            # the dense O(N^2) build; packed and solo build alike
            use_cell_list=True,
            temperature=self.tsched, field=self.fsched,
            observables=self.key.observables,
            obs_every=self.key.obs_every, per_slot=True, device=dev)
        eng.run_tags = {"bucket": self.key.id}
        eng.evict_slot_hook = self._evict_hook
        if getattr(self.cfg, "faults", None) is not None:
            install_faults(eng, self.cfg.faults, runlog=self.cfg.runlog)
        return eng

    def _generator(self, device, seed: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(int(seed))

    def _start_engine(self) -> None:
        job0 = next(h for h in self.handles if h is not None).job
        dev = job0.state.pos.device
        states, tlist, flist, gens = [], [], [], []
        for h in self.handles:
            if h is not None:
                states.append(h.job.state)
                ts, fs = self._job_schedules(h.job)
                gens.append(self._generator(dev, h.job.seed))
            else:   # idle slot: the bucket geometry at T=0, discarded
                states.append(job0.state)
                ts, fs = self._idle_schedules()
                gens.append(self._generator(dev, 0))
            tlist.append(ts)
            flist.append(fs)
        self.tsched = protocol.stack_schedules(tlist, k=self.key.knots)
        self.fsched = protocol.stack_schedules(flist, k=self.key.knots)
        self.gens = gens
        with _on_device(dev):
            self.engine = self._build_engine(job0, stack_states(states))

    def _backfill(self, slot: int, handle) -> None:
        """Seat a queued job into a freed slot between segments: its
        schedule rows, a fresh generator from its seed, and its state
        through ``write_slots`` (the other slots keep their bits)."""
        job = handle.job
        ts, fs = self._job_schedules(job)
        self._set_slot_protocol(slot, ts, fs)
        self.gens[slot] = self._generator(self.engine.device, job.seed)
        with _on_device(self.engine.device):
            self.engine.write_slots([slot], stack_states([job.state]),
                                    field=self.fsched)
        self.backfills += 1

    # -- failure isolation ---------------------------------------------
    def _evict_hook(self, err: HealthError):
        """Supervisor hook: blame one slot, retire its job, keep the rest."""
        slot = attribute_slot(err.signals, err.kind)
        if slot is None or not (0 <= slot < self.key.slots):
            return None
        h = self.handles[slot]
        if h is None:
            return None
        ts, fs = self._idle_schedules()
        self._set_slot_protocol(slot, ts, fs)
        self.handles[slot] = None
        disposition = self._retire(h, slot, err.kind or "unknown",
                                   str(err))
        return {"bucket": self.key.id, "slot": slot, "job": h.id,
                "tenant": h.tenant, "disposition": disposition}

    def _fail_bucket(self, err) -> None:
        self.failed = True
        seated = [(i, h) for i, h in enumerate(self.handles)
                  if h is not None]
        for i, h in seated:
            self.handles[i] = None
            h.finish(FAILED, error=str(err))
            append_event(self.cfg.runlog, "job_failed", job=h.id,
                         tenant=h.tenant, bucket=self.key.id,
                         error=str(err))
            self._jlog("failed", job=h.id, digest=h.digest,
                       tenant=h.tenant, status=FAILED, kind="bucket")
        while len(self.queue):
            h = self.queue.pop()
            h.finish(FAILED, error=str(err))
            append_event(self.cfg.runlog, "job_failed", job=h.id,
                         tenant=h.tenant, bucket=self.key.id,
                         error=str(err))
            self._jlog("failed", job=h.id, digest=h.digest,
                       tenant=h.tenant, status=FAILED, kind="bucket")
        append_event(self.cfg.runlog, "bucket_failed",
                     bucket=self.key.id, error=str(err))

    # -- the segment loop ----------------------------------------------
    def _active(self) -> dict:
        return {i: h for i, h in enumerate(self.handles) if h is not None}

    def run_chunk(self) -> bool:
        """Advance the batch one ``chunk``-step segment; returns True if
        any work was done."""
        self._seat()
        active = self._active()
        if not active and self.quarantine:
            # quarantine is the only work: wait out the earliest backoff
            # so drain() keeps its liveness guarantee
            wait = min(h._ready_t for h in self.quarantine) - time.time()
            if wait > 0:
                time.sleep(wait)
            self._seat()
            active = self._active()
        if self.engine is None or self.failed or not active:
            return False
        chunk = self.key.chunk
        checkpointed = (self.supervisor is not None
                        or self.journal is not None)
        if checkpointed:
            # rebase checkpoint step tags onto the monotonic bucket clock
            # (slot 0's own clock resets on backfill; journal refs can't)
            self.engine.ckpt_step_offset = (
                self.segments * chunk - self.engine._step_now())
        tel = Telemetry(runlog=self.cfg.runlog, health=self.cfg.health,
                        append=True)
        t_seg = time.perf_counter()
        try:
            with _on_device(self.engine.device):
                if self.supervisor is not None:
                    # the rollback writes the checkpoint's generator
                    # states into self.gens, so they stay live
                    self.supervisor.run(
                        self.engine, chunk, self.gens, chunk=chunk,
                        checkpoint_dir=self._ckpt_dir, telemetry=tel)
                elif self.journal is not None:
                    self.engine.run(chunk, self.gens, chunk,
                                    checkpoint_dir=self._ckpt_dir,
                                    telemetry=tel)
                else:
                    self.engine.run(chunk, self.gens, chunk, telemetry=tel)
        except HealthError as err:
            self._fail_bucket(err)
            return False
        wall = time.perf_counter() - t_seg
        self.segments += 1

        evicted = [i for i in active if self.handles[i] is None]
        append_event(
            self.cfg.runlog, "serve_chunk", bucket=self.key.id,
            steps=chunk, wall_s=wall,
            slots={str(i): {"job": h.id, "tenant": h.tenant}
                   for i, h in active.items()},
            evicted=evicted,
            idle=[i for i in range(self.key.slots) if i not in active])
        self._harvest(active)
        self._enforce_boundary()
        self._jlog(
            "commit", segment=self.segments,
            ckpt_step=self.segments * chunk if checkpointed else None,
            slots={str(i): {"job": h.id, "digest": h.digest,
                            "done": h.done_steps}
                   for i, h in self._active().items()})
        return True

    def _harvest(self, active: dict) -> None:
        """Stream this segment's observable rows to each active handle
        and retire jobs that used up their step budget."""
        eng = self.engine
        obs = self.key.obs_every
        dt = eng.cfg.dt
        chunk = self.key.chunk
        for slot, h in active.items():
            if self.handles[slot] is not h:
                continue    # evicted during this segment
            have = h.rows_base + h.rows_streamed
            want = h.job.steps // obs
            take = min(chunk // obs, want - have)
            if take > 0:
                rows = {name: np.asarray(eng.trace.values[name][:take, slot])
                        for name in self.key.observables}
                times = (np.arange(have, have + take) + 1) * obs * dt
                h.stream(times, rows)
            h.done_steps += chunk
            if h.done_steps >= h.job.steps:
                final = (_slot_state(eng.state, slot)
                         if h.done_steps == h.job.steps else None)
                h.finish(DONE, final_state=final)
                append_event(self.cfg.runlog, "job_done", job=h.id,
                             tenant=h.tenant, bucket=self.key.id,
                             steps=h.done_steps, requested=h.job.steps)
                self._jlog("completed", job=h.id, digest=h.digest,
                           tenant=h.tenant, steps=h.done_steps)
                self.handles[slot] = None

    def _enforce_boundary(self) -> None:
        """Chunk-boundary policy sweep over still-seated jobs: caller
        cancellation first, then deadline/timeout expiry."""
        for slot, h in self._active().items():
            if h.cancel_requested:
                ts, fs = self._idle_schedules()
                self._set_slot_protocol(slot, ts, fs)
                self.handles[slot] = None
                h.finish(CANCELLED)
                append_event(self.cfg.runlog, "job_cancelled", job=h.id,
                             tenant=h.tenant, bucket=self.key.id)
                self._jlog("cancelled", job=h.id, digest=h.digest,
                           tenant=h.tenant)
                continue
            kind = self._expired_kind(h)
            if kind is not None:
                ts, fs = self._idle_schedules()
                self._set_slot_protocol(slot, ts, fs)
                self.handles[slot] = None
                self._retire(h, slot, kind,
                             f"{kind} exceeded at chunk boundary")
