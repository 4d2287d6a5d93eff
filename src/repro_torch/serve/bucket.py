"""Shape-bucketing: which jobs may share one packed Engine (port of
``repro.serve.bucket``).

The unit of batching is the *bucket*: jobs whose geometry, potential,
integrator config, neighbor layout, observables and cadence are identical
run as slots of one per-slot ``Replicated`` Engine.  :func:`bucket_key`
reduces a :class:`~repro_torch.serve.queue.SimJob` to a hashable
:class:`BucketKey`; the server keeps one packed Engine per key and asserts
(through the runlog's build watchdog) that no kernel library is built or
loaded after a bucket's first chunk.

Every digest here is over the BYTES of host copies of the arrays
(``.detach().cpu().numpy()`` for tensors, on any device), with the numpy
dtype's name, so a digest is the same in every process -
``SimServer.recover`` matches resubmitted jobs on it:

* geometry over positions / box / types / masses / magnetic flags, not
  just shapes: the replica plan builds ONE shared neighbor table from the
  slots' positions, so same-bucket jobs must share a crystalline
  reference exactly (spins and velocities are free per job);
* the potential over its parameter tensors' bytes (the reference digests
  ``repr`` of the fields, which summarises an array past 1,000 elements:
  two weight sets that differ only in elided entries share its bucket).

Schedule knot counts are padded to the bucket's ``knots``
(:func:`repro_torch.ensemble.protocol.pad_schedule`) so heterogeneous
protocols share the one ``(R, K)`` schedule stack.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch


def _h(update_parts) -> str:
    h = hashlib.sha1()
    for part in update_parts:
        h.update(part)
    return h.hexdigest()[:12]


def _host(x) -> np.ndarray:
    """A host numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _array_parts(x) -> list:
    a = np.ascontiguousarray(_host(x))
    return [str((a.shape, a.dtype.name)).encode(), a.tobytes()]


def geometry_digest(state, masses, magnetic) -> str:
    """Digest of the crystalline geometry (array bytes, see module doc)."""
    parts = []
    for a in (state.pos, state.box, state.types, masses, magnetic):
        parts += _array_parts(a)
    return _h(parts)


def _value_parts(name: str, v) -> list:
    """Digestable parts of one potential field: tensors and arrays by
    their bytes, tuples / NamedTuples / dataclasses field by field, other
    values by ``repr``."""
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return [name.encode()] + _array_parts(v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        out = [name.encode(), type(v).__name__.encode()]
        for f in dataclasses.fields(v):
            out += _value_parts(f"{name}.{f.name}", getattr(v, f.name))
        return out
    if isinstance(v, tuple):
        fields = getattr(v, "_fields", None) or range(len(v))
        out = [name.encode(), type(v).__name__.encode()]
        for k, item in zip(fields, v):
            out += _value_parts(f"{name}.{k}", item)
        return out
    return [name.encode(), repr(v).encode()]


def potential_digest(potential) -> str:
    """Digest of the potential's type and parameters: a dataclass field by
    field (tensors by their bytes), else ``repr``."""
    if dataclasses.is_dataclass(potential):
        parts = []
        for f in sorted(dataclasses.fields(potential), key=lambda f: f.name):
            parts += _value_parts(f.name, getattr(potential, f.name))
    else:
        parts = [repr(potential).encode()]
    return _h([type(potential).__name__.encode()] + parts)


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Hashable signature of one shape bucket (see module doc)."""

    geometry: str          # geometry_digest of state/masses/magnetic
    potential: str         # potential_digest
    integrator: tuple      # IntegratorConfig field values
    cutoff: float
    skin: float
    capacity: int
    observables: tuple
    obs_every: int
    knots: int             # padded schedule knot count K
    chunk: int             # server segment length [steps]
    slots: int             # replica slots per packed batch

    @property
    def id(self) -> str:
        """Short stable id for runlog tags and checkpoint directories."""
        return _h([repr(self).encode()])[:8]


def _schedule_digest_parts(x) -> list:
    """Digestable byte parts of a protocol leg (None | scalar | Schedule)."""
    parts = [type(x).__name__.encode()]
    if x is None:
        return parts
    for attr in ("knots_t", "knots_v", "t", "v", "times", "values"):
        v = getattr(x, attr, None)
        if v is not None:
            parts.append(attr.encode())
            parts.append(np.ascontiguousarray(_host(v)).tobytes())
    if len(parts) == 1:            # plain scalar / array protocol
        parts.append(np.ascontiguousarray(_host(x)).tobytes())
    return parts


def job_digest(job) -> str:
    """Content digest identifying one submitted job request.

    This is the journal's idempotency key: resubmitting the same request
    after a crash maps onto the journaled lifecycle of the original, so
    completed work is never recomputed (or re-charged) and interrupted
    work resumes from its watermark.  Digested over the ORIGINAL request -
    the full dynamical state (spins/velocities, not just the bucket's
    crystalline geometry), the protocol's actual knots, the step/seed/
    cadence budget, and the tenant - but NOT over server-side mutations
    (an overload-stretched ``obs_every`` is recorded in the journal's
    ``admitted`` event instead)."""
    parts = [geometry_digest(job.state, job.masses, job.magnetic).encode(),
             potential_digest(job.potential).encode()]
    for a in (job.state.spin, job.state.vel):
        parts.append(np.ascontiguousarray(_host(a)).tobytes())
    parts += _schedule_digest_parts(job.temperature)
    parts += _schedule_digest_parts(job.field)
    parts.append(repr((job.steps, job.obs_every, job.seed, job.tenant,
                       tuple(job.observables), job.cutoff, job.skin,
                       job.capacity, job.name, job.deadline_steps,
                       job.timeout_s)).encode())
    return _h(parts)


def bucket_key(job, cfg) -> BucketKey:
    """Reduce a job + server config to its :class:`BucketKey`."""
    icfg = job.cfg
    if dataclasses.is_dataclass(icfg):
        integ = tuple((f.name, getattr(icfg, f.name))
                      for f in dataclasses.fields(icfg))
    else:
        integ = (repr(icfg),)
    return BucketKey(
        geometry=geometry_digest(job.state, job.masses, job.magnetic),
        potential=potential_digest(job.potential),
        integrator=integ,
        cutoff=float(job.cutoff), skin=float(job.skin),
        capacity=int(job.capacity),
        observables=tuple(job.observables),
        obs_every=int(job.obs_every),
        knots=int(cfg.schedule_knots),
        chunk=int(cfg.chunk), slots=int(cfg.slots))
