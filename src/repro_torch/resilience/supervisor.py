"""Rollback-retry supervision of ``Engine.run`` with graceful degradation
(port of ``repro.resilience.supervisor``).

The health gate runs BEFORE checkpointing, so the newest checkpoint is
always good, which makes recovery mechanical:

1. ``Engine.run`` raises a structured
   :class:`~repro_torch.telemetry.monitor.HealthError` at a chunk boundary.
2. The supervisor restores the newest checkpoint this run wrote - the
   carry and the run's generator(s), written into the caller's own
   generator objects, so the re-run draws the same noise - **pins** it so
   the
   checkpoint GC never collects the rollback target, waits out the
   backoff, and re-runs the remaining steps.
3. A plain retry reuses the kernels already built and loaded: with an
   unchanged config it costs zero builds (the runlog's chunk records,
   from the :class:`~repro_torch.telemetry.metrics.CompileWatchdog`).
4. ``degrade_after`` consecutive failures of the SAME class climb the
   degradation ladder keyed on ``HealthError.kind``:

   - the serving rung, when the engine carries an ``evict_slot_hook``
     (per-slot batches): the failing chunk's per-slot signals
     (:func:`attribute_slot`) pin the fault on one slot, the hook evicts
     that job, and the batch retries with its healthy batch-mates
     untouched;
   - ``overflow``: rebind the Sharded plan at ``capacity_factor`` x the
     resolved cell capacity (permanent: the layout was too small);
   - ``nonfinite`` / ``drift`` / ``spin``: rebind at ``dt_factor`` x dt,
     integrate ``degrade_span`` chunks through the trouble spot, then
     restore the original config and continue at full dt.

:meth:`Supervisor.elastic_restore` restores a Sharded checkpoint onto
another mesh (``Engine.restore(..., plan=...)``) and logs the layout
transition.

Every rollback / retry / degrade / give-up lands in the runlog as a
structured record (:mod:`repro_torch.launch.report` renders them); retry
segments re-open the runlog in append mode, so one file tells the whole
story.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.telemetry import HealthError, as_telemetry
from repro_torch.telemetry.runlog import append_event

_TRANSIENT = ("nonfinite", "drift", "spin")


def backoff_delay(attempt: int, base: float, factor: float = 2.0,
                  cap: float = 30.0) -> float:
    """Exponential backoff: ``base * factor**(attempt-1)``, capped.

    ``attempt`` is 1-based; a non-positive base (or attempt) is free."""
    if base <= 0 or attempt <= 0:
        return 0.0
    return min(base * factor ** (attempt - 1), cap)


def restore_into(generator, restored):
    """Write the generator states that ``Engine.restore`` returned into the
    caller's own ``torch.Generator`` objects (one, or a sequence of one per
    replica), so a caller that goes on with its generators after a
    supervised run continues from the rolled-back draws; returns the
    caller's generators (the restored ones when the caller passed None)."""
    if generator is None or restored is None:
        return restored if generator is None else generator
    if isinstance(restored, list):
        for mine, saved in zip(generator, restored):
            mine.set_state(saved.get_state())
    else:
        generator.set_state(restored.get_state())
    return generator


class Strikes:
    """Consecutive same-class failure counter: ``hit(kind)`` returns how
    many times ``kind`` has now failed in a row (a different kind resets
    the streak to 1)."""

    def __init__(self):
        self.kind = None
        self.count = 0

    def hit(self, kind: str | None) -> int:
        kind = kind or "unknown"
        self.count = self.count + 1 if kind == self.kind else 1
        self.kind = kind
        return self.count

    def reset(self) -> None:
        self.kind, self.count = None, 0


# HealthError.kind -> the per-slot signal vector that attributes it
_SLOT_SIGNALS = {"nonfinite": "slot_nonfinite",
                 "drift": "slot_e_drift",
                 "spin": "slot_spin_dev"}


def attribute_slot(signals: dict, kind: str | None = None) -> int | None:
    """Pin a chunk failure on one replica slot from its health signals.

    ``signals`` is ``HealthError.signals`` from a per-slot engine chunk,
    which carries the vectors ``slot_nonfinite`` / ``slot_e_drift`` /
    ``slot_spin_dev`` beside the gating scalars.  The vector matching
    ``kind`` is read first (a non-finite count, else the largest |signal|);
    with no kind, the vectors in severity order.  Returns the slot, or None
    when the signals carry no per-slot vector."""
    import numpy as np

    order = [kind] if kind in _SLOT_SIGNALS else list(_SLOT_SIGNALS)
    for k in order:
        vec = signals.get(_SLOT_SIGNALS[k])
        if vec is None:
            continue
        v = np.asarray(vec, dtype=np.float64)
        if v.ndim != 1 or v.size == 0:
            continue
        if k == "nonfinite":
            if np.nanmax(v) > 0 or np.any(~np.isfinite(v)):
                bad = ~np.isfinite(v)
                return int(np.argmax(np.where(bad, np.inf, v)))
            continue
        v = np.where(np.isfinite(v), np.abs(v), np.inf)
        if np.max(v) > 0:
            return int(np.argmax(v))
    return None


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    max_retries: int = 4        # total rollback budget per run() call
    backoff_s: float = 0.0      # sleep attempt * backoff_s before retry
    degrade_after: int = 2      # consecutive same-class fails -> ladder
    dt_factor: float = 0.5      # transient ladder: dt multiplier
    degrade_span: int = 2       # chunks to run at reduced dt
    capacity_factor: float = 2.0  # overflow ladder: capacity multiplier


class Supervisor:
    """Wraps ``Engine.run`` with rollback-retry (see the module docstring).

    One supervisor can drive many runs; ``events`` accumulates the
    structured recovery records (also written to the runlog)."""

    def __init__(self, config: SupervisorConfig | None = None, *,
                 runlog=None):
        self.config = config or SupervisorConfig()
        self.runlog = runlog        # default event sink (else tel.runlog)
        self.events: list[dict] = []

    def _event(self, log_path, event: str, **fields) -> dict:
        record = {"event": event, **fields}
        self.events.append(record)
        if log_path is not None:
            append_event(log_path, event, **fields)
        return record

    def run(self, engine, n_steps: int, generator, chunk: int = 20, *,
            checkpoint_dir: str, checkpoint_every: int = 1,
            telemetry=None, **run_kw):
        """``Engine.run`` with automatic rollback-retry.

        ``checkpoint_dir`` is mandatory: it is both the rollback store and
        the resume point.  A checkpoint is written before the first step,
        so even a chunk-0 fault has a rollback target.  ``generator`` is
        the run's ``torch.Generator`` (on the replica plan the list of one
        per replica); a rollback writes the checkpoint's generator states
        into these same objects (:func:`restore_into`), so a caller that
        runs on with them after this call continues the clean trajectory.  Keep ``n_steps`` a
        multiple of ``chunk`` so checkpoints stay chunk-aligned.

        A :class:`HealthError` rolls the engine back to the last-good
        checkpoint and retries, up to ``max_retries`` times; past that the
        error is re-raised.  When one failure class repeats
        ``degrade_after`` times, the degradation ladder engages (module
        docstring).  Returns ``engine.state``."""
        cfg = self.config
        tel = as_telemetry(telemetry)
        log_path = self.runlog if self.runlog is not None else (
            tel.runlog if tel is not None else None)
        target = engine._step_now() + n_steps
        engine.save(checkpoint_dir, generator)
        engine.ckpt_pin = engine.ckpt_step()

        attempts = 0
        strikes = Strikes()
        seg_tel = tel
        while True:
            remaining = target - engine._step_now()
            if remaining <= 0:
                break
            try:
                engine.run(remaining, generator, chunk,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every,
                           telemetry=seg_tel, **run_kw)
                break
            except HealthError as err:
                attempts += 1
                kind = err.kind or "unknown"
                same_count = strikes.hit(kind)
                self._event(
                    log_path, "rollback", kind=kind, attempt=attempts,
                    step=err.step, chunk_index=err.chunk_index,
                    signals=err.signals, checkpoint=err.checkpoint_path,
                    error=str(err))
                if attempts > cfg.max_retries:
                    self._event(log_path, "give_up", kind=kind,
                                attempts=attempts, step=err.step)
                    raise
                if cfg.backoff_s:
                    time.sleep(attempts * cfg.backoff_s)
                # the newest checkpoint THIS run wrote, not the newest in
                # the directory: a crashed earlier run (a serving bucket's
                # previous incarnation) may have left higher step tags
                generator = restore_into(generator, engine.restore(
                    checkpoint_dir, step=engine._last_ckpt_step))
                engine.ckpt_pin = engine.ckpt_step()
                if seg_tel is not None:
                    seg_tel = dataclasses.replace(seg_tel, append=True)
                if same_count >= cfg.degrade_after:
                    generator = self._degrade(
                        engine, kind, generator, chunk, checkpoint_dir,
                        checkpoint_every, seg_tel, target, log_path, run_kw,
                        err=err)
                    strikes.reset()
                self._event(log_path, "retry", attempt=attempts,
                            kind=kind, step=engine._step_now(),
                            remaining=target - engine._step_now())
        if attempts:
            self._event(log_path, "recovered", attempts=attempts,
                        step=engine._step_now())
        return engine.state

    def _degrade(self, engine, kind, generator, chunk, checkpoint_dir,
                 checkpoint_every, seg_tel, target, log_path, run_kw,
                 err=None):
        """Climb one rung of the degradation ladder; returns the
        generator(s) to continue with."""
        cfg = self.config
        hook = getattr(engine, "evict_slot_hook", None)
        if hook is not None and err is not None:
            # the serving rung: evict the one poisoned slot instead of
            # degrading the whole batch (the hook returns None when the
            # failure is not attributable to a single slot)
            info = hook(err)
            if info:
                self._event(log_path, "evict", kind=kind,
                            step=engine._step_now(), **info)
                return generator
        if kind == "overflow":
            cap = int(engine._rplan.dspec.capacity)
            new_cap = max(int(cap * cfg.capacity_factor), cap + 1)
            plan = dataclasses.replace(engine.plan, cell_capacity=new_cap)
            self._event(log_path, "degrade", kind=kind, action="capacity",
                        cell_capacity=new_cap, prev_capacity=cap,
                        step=engine._step_now())
            engine.rebind(plan=plan)    # permanent: the layout was wrong
            # the rollback target again, in the new layout (a same-mesh
            # restore reads only its own engine's layout)
            engine.save(checkpoint_dir, generator)
            engine.ckpt_pin = engine.ckpt_step()
            return generator
        if kind in _TRANSIENT:
            old_cfg = engine.cfg
            new_dt = old_cfg.dt * cfg.dt_factor
            span = min(cfg.degrade_span * chunk,
                       target - engine._step_now())
            if span <= 0:
                # degrade_span=0 disables the dt rung (a packed serving
                # batch must never integrate at a different dt)
                self._event(log_path, "degrade", kind=kind, action="none",
                            step=engine._step_now())
                return generator
            self._event(log_path, "degrade", kind=kind, action="dt",
                        dt=new_dt, prev_dt=old_cfg.dt, span_steps=span,
                        step=engine._step_now())
            engine.rebind(cfg=dataclasses.replace(old_cfg, dt=new_dt))
            try:
                # the live carry and generator(s) go on: a torch generator
                # advances in place, so unlike the reference's functional
                # key nothing has to be read back from the checkpoint
                engine.run(span, generator, chunk,
                           checkpoint_dir=checkpoint_dir,
                           checkpoint_every=checkpoint_every,
                           telemetry=seg_tel, **run_kw)
                engine.ckpt_pin = engine.ckpt_step()
            finally:
                engine.rebind(cfg=old_cfg)
                self._event(log_path, "degrade_restore", kind=kind,
                            dt=old_cfg.dt, step=engine._step_now())
            return generator
        self._event(log_path, "degrade", kind=kind, action="none",
                    step=engine._step_now())
        return generator

    def elastic_restore(self, engine, checkpoint_dir, plan, *,
                        step: int | None = None, runlog=None):
        """``Engine.restore(..., plan=...)`` plus the event record: restore
        a Sharded checkpoint onto another mesh or rank count and log the
        layout transition (``from_layout`` / ``to_layout``).  Returns this
        rank's generator (:meth:`repro_torch.md.engine.Engine.restore`)."""
        log_path = runlog if runlog is not None else self.runlog
        rp = getattr(engine, "_rplan", None)
        before = (rp.describe() if rp is not None
                  else {"plan": type(engine.plan).__name__})
        gen = engine.restore(checkpoint_dir, step=step, plan=plan)
        after = engine._rplan.describe()
        engine.ckpt_pin = engine.ckpt_step()
        self._event(log_path, "elastic_restore",
                    step=engine._step_now(), from_layout=before,
                    to_layout=after, checkpoint=str(checkpoint_dir))
        return gen
