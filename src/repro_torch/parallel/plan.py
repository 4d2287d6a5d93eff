"""Parallel plans: the execution-layout axis of the MD engine (port of
``repro.parallel.plan``).

Only :class:`SingleDevice` - flat (N, ...) tensors on one device,
optionally in cell-ordered rows - is ported.  The reference's
``Replicated`` plan (ROADMAP queue 1 item 9) and ``Sharded`` plan (item
13) raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Flat single-device plan."""

    cell_order: bool | None = None   # linked-cell row sort; None -> iff cell list


def as_plan(plan):
    """Normalize ``plan`` (None | "single" | SingleDevice) to a plan object."""
    if plan is None or plan in ("single", "single_device", "flat"):
        return SingleDevice()
    if isinstance(plan, SingleDevice):
        return plan
    raise NotImplementedError(
        f"plan {plan!r} is not ported yet; only SingleDevice runs (the "
        "Replicated plan is ROADMAP queue 1 item 9, the Sharded plan "
        "item 13)")
