"""Collective-communication accounting for the roofline (the counterpart
of ``repro.utils.hlo``).

The reference parses the collectives out of compiled HLO text.  The port
has no HLO: every halo exchange, fold and energy reduction of the domain
layer records its tag and per-rank message bytes into the active
:class:`repro_torch.parallel.halo.HaloTrace` as it is called, so the
ledger already holds what the parse recovers, in the same ``{kind:
{"count", "bytes"}}`` shape (a kind is a ledger tag: ``"legacy-pos"``,
``"qfp"``, ``"energy"``, ...).  Calls are recorded as they run, so loop
trip counts are exact and ``unknown_trips`` is always False.
"""
from __future__ import annotations


def _ledger(ledger) -> tuple[dict, dict]:
    """(counts, bytes) of a HaloTrace or of its ``snapshot()`` dict."""
    if isinstance(ledger, dict):
        return ledger.get("counts", {}), ledger.get("bytes", {})
    return ledger.counts, ledger.bytes


def parse_collectives(ledger) -> dict[str, dict[str, int]]:
    """``{tag: {"count": calls, "bytes": per-rank message bytes}}``."""
    counts, nbytes = _ledger(ledger)
    return {tag: {"count": int(counts.get(tag, 0)),
                  "bytes": int(nbytes.get(tag, 0))}
            for tag in sorted(set(counts) | set(nbytes))}


def collective_bytes(ledger) -> int:
    """Total per-rank collective bytes over every tag."""
    return int(sum(v["bytes"] for v in parse_collectives(ledger).values()))


def collectives_with_trips(ledger) -> dict:
    """The reference's loop-aware record: ``{"per_kind", "unknown_trips"}``
    (the ledger counts each call as it runs)."""
    return {"per_kind": parse_collectives(ledger), "unknown_trips": False}


def count_op(record, opname: str) -> int:
    """How many times the aten op ``opname`` (``"mm"``, ``"index"``, ...)
    ran under a :class:`repro_torch.utils.cost.CostCounter` (the counter,
    or its ``record()`` dict)."""
    ops = record["ops"] if isinstance(record, dict) else record.ops
    return int(ops.get(opname, 0))
