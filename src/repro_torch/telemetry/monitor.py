"""Health monitoring: signals, thresholds, and structured abort (port of
``repro.telemetry.monitor``).

The Engine computes a small dict of health signals at every chunk boundary
on the device and reads them back in one transfer:

    e_drift    total energy (potential + kinetic) at chunk end minus chunk
               start [eV]; on the replica plan the signed drift of the
               replica with the largest magnitude
    spin_dev   max | |s| - 1 | over magnetic atoms
    nonfinite  count of non-finite entries across positions, forces, spins
    nbr_occ    max neighbor-slot occupancy fraction (1.0 = a full row: the
               next rebuild may truncate)

A replica plan in per-slot mode adds one vector per signal, one entry per
slot (:func:`slot_signals`): ``slot_nonfinite``, ``slot_e_drift`` and
``slot_spin_dev``.  The check gates on the scalars; the vectors ride along
in the runlog and in :class:`HealthError`'s signals, so a failure can be
pinned on one slot.

They land in ``EngineTrace.health`` (one row per chunk).  With a telemetry
config, :func:`check_chunk` compares them against :class:`HealthConfig` and
raises a structured :class:`HealthError` that names the last-good
checkpoint, so a driver can abort and resume instead of integrating
garbage.
"""
from __future__ import annotations

import dataclasses

import torch


class HealthError(RuntimeError):
    """A health check failed at a chunk boundary.

    ``step`` (global step at the failing boundary), ``chunk_index``
    (0-based), ``signals`` (the host signal dict), ``checkpoint_path`` (the
    last-good checkpoint written by ``Engine.save``, or None) and ``kind``
    ("nonfinite" | "drift" | "spin" | None)."""

    def __init__(self, message: str, *, step: int | None = None,
                 chunk_index: int | None = None, signals: dict | None = None,
                 checkpoint_path: str | None = None,
                 kind: str | None = None):
        if checkpoint_path is not None:
            message += f" [last-good checkpoint: {checkpoint_path}]"
        super().__init__(message)
        self.step = step
        self.chunk_index = chunk_index
        self.signals = dict(signals or {})
        self.checkpoint_path = checkpoint_path
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Chunk-boundary thresholds; ``None`` disables a check.  Occupancy
    past ``warn_occupancy`` only downgrades the verdict to "warn"."""

    fail_on_nonfinite: bool = True
    max_energy_drift: float | None = None   # |e_drift| bound [eV]
    max_spin_dev: float | None = None       # | |s|-1 | bound
    warn_occupancy: float = 1.0             # neighbor occupancy warn level


# ---------------------------------------------------------------------------
# device-side signals (0-d tensors; the caller reads them back together)
# ---------------------------------------------------------------------------

def spin_norm_dev(spin: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max ``| |s| - 1 |`` over rows where ``mask`` is True (0 if none)."""
    dev = torch.abs(torch.linalg.norm(spin, dim=-1) - 1.0)
    return torch.max(torch.where(mask, dev, torch.zeros_like(dev)))


def nonfinite_count(*tensors: torch.Tensor) -> torch.Tensor:
    """Total count of non-finite entries across ``tensors``."""
    return sum(torch.sum(~torch.isfinite(t)) for t in tensors)


def slot_signals(pos: torch.Tensor, force: torch.Tensor, spin: torch.Tensor,
                 mag: torch.Tensor, drift: torch.Tensor) -> dict:
    """Per-slot health vectors (R,) of a replica batch: ``pos``, ``force``,
    ``spin`` (R, N, 3), ``mag`` (R, N) magnetic-atom mask, ``drift`` (R,)
    each slot's energy drift."""
    slots = range(pos.shape[0])
    return {"slot_nonfinite": torch.stack([nonfinite_count(
                pos[r], force[r], spin[r]) for r in slots]),
            "slot_e_drift": drift,
            "slot_spin_dev": torch.stack([spin_norm_dev(spin[r], mag[r])
                                          for r in slots])}


def occupancy_fraction(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max occupied fraction of a padded slot axis (neighbor rows)."""
    cap = max(mask.shape[dim], 1)
    return torch.max(torch.sum(mask, dim=dim)) / float(cap)


# ---------------------------------------------------------------------------
# host-side chunk-boundary check
# ---------------------------------------------------------------------------

def check_chunk(signals: dict, cfg: HealthConfig, *, step: int,
                chunk_index: int,
                checkpoint_path: str | None = None) -> str:
    """Return the chunk verdict ("ok" | "warn") or raise
    :class:`HealthError`; ``signals`` are host floats and ints."""
    fails, kinds = [], []
    if cfg.fail_on_nonfinite and signals.get("nonfinite", 0) > 0:
        fails.append(f"{int(signals['nonfinite'])} non-finite value(s) in "
                     "positions/forces/spins")
        kinds.append("nonfinite")
    drift = signals.get("e_drift")
    if (cfg.max_energy_drift is not None and drift is not None
            and abs(drift) > cfg.max_energy_drift):
        fails.append(f"energy drift {drift:+.3e} eV exceeds "
                     f"{cfg.max_energy_drift:.3e}")
        kinds.append("drift")
    sdev = signals.get("spin_dev")
    if (cfg.max_spin_dev is not None and sdev is not None
            and sdev > cfg.max_spin_dev):
        fails.append(f"spin-norm deviation {sdev:.3e} exceeds "
                     f"{cfg.max_spin_dev:.3e}")
        kinds.append("spin")
    if fails:
        raise HealthError(
            f"health check failed at step {step} (chunk {chunk_index}): "
            + "; ".join(fails),
            step=step, chunk_index=chunk_index, signals=signals,
            checkpoint_path=checkpoint_path, kind=kinds[0])
    if signals.get("nbr_occ", 0.0) >= cfg.warn_occupancy:
        return "warn"
    return "ok"
