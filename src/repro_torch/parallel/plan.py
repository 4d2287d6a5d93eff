"""Parallel plans: the execution-layout axis of the MD engine (port of
``repro.parallel.plan``).

  :class:`SingleDevice`   flat (N, ...) tensors on one device, optionally in
                          cell-ordered rows.
  :class:`Replicated`     a leading replica axis over the same loop: one
                          shared neighbor table, per-replica ``dr`` /
                          forces / generators, K1 and K2 launched once for
                          all replicas.  On one card only: sharding the
                          replica axis over several cards is ROADMAP queue
                          1 item 13.

The reference's ``Sharded`` plan (item 13) raises ``NotImplementedError``
here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Flat single-device plan."""

    cell_order: bool | None = None   # linked-cell row sort; None -> iff cell list

    replicas: int = 0                # uniform plan API


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Replica plan: an (R, N, ...) batch through one loop on one card."""

    replicas: int
    devices: tuple | None = None     # more than one raises (item 13)

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("Replicated plan needs replicas >= 1")


def as_plan(plan, replicas: int = 0):
    """Normalize ``plan`` (None | "single" | "replica" | plan object) to a
    plan object."""
    if plan is None:
        plan = "replica" if replicas else "single"
    if isinstance(plan, str):
        if plan in ("single", "single_device", "flat"):
            return SingleDevice()
        if plan in ("replica", "replicated"):
            return Replicated(replicas=max(replicas, 1))
        if plan in ("domain", "sharded", "shard_map"):
            plan = "the Sharded plan"
    if isinstance(plan, (SingleDevice, Replicated)):
        return plan
    raise NotImplementedError(
        f"plan {plan!r} is not ported yet; SingleDevice and Replicated run "
        "(the Sharded plan is ROADMAP queue 1 item 13)")
