"""Job requests, streaming handles, and the FIFO queue (port of
``repro.serve.queue``).

A :class:`SimJob` is one tenant's simulation request: an initial state,
a potential, an integrator config, a (T, B) protocol, and a step budget
with an ``obs_every`` observation cadence.  ``SimServer.submit`` wraps it
in a :class:`JobHandle` - the caller's end of the stream: observables
arrive per packed segment (:meth:`JobHandle.stream`), completion flips
the status (:meth:`JobHandle.finish`), and :meth:`JobHandle.wait` blocks
until the job leaves the batch.  Handles are thread-safe; the packer is
the only writer.

Statuses walk ``QUEUED -> RUNNING -> DONE`` on the happy path.  Terminal
ends: ``FAILED`` (the whole bucket died, or the job expired / struck out
permanently), ``EVICTED`` (the supervisor pinned a health failure on this
job's slot and removed it so its batch-mates could continue; see
:mod:`repro_torch.resilience.supervisor`), ``CANCELLED`` (the caller's
:meth:`JobHandle.cancel`), and ``SHED`` (load-shedding admission dropped
it under overload).  ``QUARANTINED`` is the one extra NON-terminal state:
an evicted/expired job sitting out its backoff before a requeue
(:class:`RequeuePolicy`).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

import numpy as np

QUEUED = "queued"
RUNNING = "running"
QUARANTINED = "quarantined"     # evicted, awaiting backoff requeue
DONE = "done"
FAILED = "failed"
EVICTED = "evicted"
CANCELLED = "cancelled"
SHED = "shed"

COMPLETED = DONE                # alias: the public terminal-state name

_TERMINAL = (DONE, FAILED, EVICTED, CANCELLED, SHED)
TERMINAL = _TERMINAL               # public: the packer/server gate on it


@dataclasses.dataclass(frozen=True)
class RequeuePolicy:
    """Bounded-retry policy for evicted / expired jobs.

    ``retries`` extra seatings after the first (0 = evict is final, the
    pre-journal behavior).  Backoff before the n-th requeue is
    ``backoff_s * 2**(n-1)``
    (:func:`repro_torch.resilience.supervisor.backoff_delay`).
    ``max_strikes`` consecutive same-class failures (keyed on
    ``HealthError.kind``, mirroring the supervisor ladder) classify the
    job as a permanent failure even with retry budget left."""

    retries: int = 0
    backoff_s: float = 0.05
    max_strikes: int = 2


@dataclasses.dataclass
class SimJob:
    """One simulation request (see :mod:`repro_torch.serve`).

    ``state`` is a single unbatched
    :class:`~repro_torch.md.state.SpinLatticeState` of tensors on the card
    the job runs on (the geometry part of the shape-bucket key -
    same-geometry jobs share one packed Engine).  ``temperature`` /
    ``field`` accept None, a constant, or a
    :class:`~repro_torch.ensemble.protocol.Schedule` evaluated on
    the job's OWN clock from step 0, regardless of when the job is packed
    into a running batch.  ``steps`` must be a multiple of ``obs_every``;
    the job is integrated in whole server chunks, so a job whose ``steps``
    is not chunk-aligned still streams exactly ``steps/obs_every``
    observable rows but reports no final state (it overshot).
    """

    state: Any                      # SpinLatticeState, (N, ...) unbatched
    potential: Any                  # gather-once .compute() surface
    cfg: Any                        # IntegratorConfig
    masses: Any                     # (T,) per-type masses [amu]
    magnetic: Any                   # (T,) per-type magnetic flags
    steps: int                      # requested integration steps
    cutoff: float = 5.0             # neighbor cutoff [A]
    temperature: Any = None         # None | K | Schedule (job clock)
    field: Any = None               # None | (3,) T | Schedule (job clock)
    observables: tuple = ("energy", "magnetization")
    obs_every: int = 5              # emission cadence [steps]
    seed: int = 0                   # job RNG stream (thermostat noise)
    tenant: str = "default"         # accounting principal
    capacity: int = 16              # neighbor-table capacity
    skin: float = 0.2               # Verlet skin [A]
    name: str | None = None         # optional human label
    deadline_steps: int | None = None   # bucket-step budget from admission
    timeout_s: float | None = None      # wall-clock budget from submit


class JobHandle:
    """The caller's end of one submitted job (thread-safe).

    The packer streams observable rows in as segments complete;
    ``observables`` / ``times`` expose everything received so far as
    concatenated numpy arrays.  ``final_state`` is the job's state after
    exactly ``job.steps`` steps when the budget was chunk-aligned, else
    None.  :meth:`wait` blocks until the status is terminal.
    """

    def __init__(self, job: SimJob, job_id: str, bucket=None,
                 digest: str | None = None):
        self.job = job
        self.id = job_id
        self.bucket = bucket        # BucketKey this job was binned into
        self.digest = digest        # job_digest: idempotent-recovery key
        self.tenant = job.tenant
        self.status = QUEUED
        self.error: str | None = None
        self.final_state = None
        self.done_steps = 0         # integrated steps (may overshoot)
        self.rows_base = 0          # rows committed pre-recovery (not here)
        self.recovered = False      # re-seated by SimServer.recover
        self.attempts = 0           # seatings so far (requeue accounting)
        self.submitted_t = time.time()      # wall clock for timeout_s
        self.enqueued_at_steps = 0  # bucket clock at (re)admission
        self.cancel_requested = False
        self._ready_t = 0.0         # quarantine: earliest requeue time
        self._times: list = []
        self._rows: list[dict] = []
        self._cv = threading.Condition()

    # -- packer side ---------------------------------------------------
    def mark_running(self) -> None:
        with self._cv:
            self.status = RUNNING

    def stream(self, times, rows: dict) -> None:
        """Append one segment's observable rows (packer only)."""
        with self._cv:
            self._times.append(np.asarray(times))
            self._rows.append({k: np.asarray(v) for k, v in rows.items()})
            self._cv.notify_all()

    def finish(self, status: str, *, final_state=None,
               error: str | None = None) -> None:
        if status not in _TERMINAL:
            raise ValueError(f"finish() needs a terminal status, "
                             f"got {status!r}")
        with self._cv:
            if self.status in _TERMINAL:    # first terminal verdict wins
                return
            self.status = status
            self.final_state = final_state
            self.error = error
            self._cv.notify_all()

    def quarantine(self, ready_t: float, error: str | None = None) -> None:
        """Park an evicted job until ``ready_t`` (packer only)."""
        with self._cv:
            if self.status in _TERMINAL:
                return
            self.status = QUARANTINED
            self.error = error
            self._ready_t = ready_t
            self._cv.notify_all()

    def requeue(self) -> bool:
        """QUARANTINED -> QUEUED once backoff elapsed (packer only);
        False if the job went terminal while parked."""
        with self._cv:
            if self.status != QUARANTINED:
                return False
            self.status = QUEUED
            return True

    def reset_progress(self) -> None:
        """Drop streamed rows + progress before a requeue re-seats the job
        from step 0 (its slot state was lost with the eviction)."""
        with self._cv:
            self.done_steps = 0
            self.rows_base = 0
            self._times.clear()
            self._rows.clear()

    # -- caller side ---------------------------------------------------
    @property
    def rows_streamed(self) -> int:
        with self._cv:
            return sum(t.shape[0] for t in self._times)

    @property
    def times(self) -> np.ndarray:
        """Observation times [ps] on the job's own clock (from step 0)."""
        with self._cv:
            if not self._times:
                return np.zeros((0,))
            return np.concatenate(self._times)

    @property
    def observables(self) -> dict:
        """Streamed observable rows so far, one array per name."""
        with self._cv:
            if not self._rows:
                return {}
            names = self._rows[0].keys()
            return {k: np.concatenate([r[k] for r in self._rows])
                    for k in names}

    def wait(self, timeout: float | None = None) -> str:
        """Block until the job reaches a terminal status; returns it."""
        with self._cv:
            self._cv.wait_for(lambda: self.status in _TERMINAL,
                              timeout=timeout)
            return self.status

    def cancel(self) -> bool:
        """Request cancellation; returns True if the job WILL terminate
        ``CANCELLED``.

        A queued or quarantined job cancels immediately (it never runs).
        A running job is marked and the packer retires it at the next
        chunk boundary - a segment runs to its end, so cancellation is
        chunk-granular by design.  A job already terminal is
        unaffected (returns False)."""
        with self._cv:
            if self.status in _TERMINAL:
                return False
            self.cancel_requested = True
            if self.status in (QUEUED, QUARANTINED):
                self.status = CANCELLED
                self._cv.notify_all()
        return True


class JobQueue:
    """Thread-safe FIFO of :class:`JobHandle` (one per shape bucket)."""

    def __init__(self):
        self._q: deque[JobHandle] = deque()
        self._lock = threading.Lock()

    def push(self, handle: JobHandle) -> None:
        with self._lock:
            self._q.append(handle)

    def pop(self) -> JobHandle | None:
        with self._lock:
            return self._q.popleft() if self._q else None

    def remove(self, handle: JobHandle) -> bool:
        """Drop one queued handle (load-shedding victim); False if gone."""
        with self._lock:
            try:
                self._q.remove(handle)
                return True
            except ValueError:
                return False

    def peek_all(self) -> list[JobHandle]:
        """Snapshot of the queued handles (shed-victim selection)."""
        with self._lock:
            return list(self._q)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)
