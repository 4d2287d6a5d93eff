"""Collective-communication accounting for the roofline (the counterpart
of ``repro.utils.hlo``).

The reference parses the collectives out of compiled HLO text.  The port
has no HLO; it has two ledgers, each already holding what the parse
recovers, in the same ``{kind: {"count", "bytes"}}`` shape:

* the MD domain layer: every halo exchange, fold and energy reduction
  records its tag and per-rank message bytes into the active
  :class:`repro_torch.parallel.halo.HaloTrace` as it is called (a kind is
  a ledger tag: ``"legacy-pos"``, ``"qfp"``, ``"energy"``, ...);
* a step on DTensors (the LM zoo on a mesh):
  :class:`repro_torch.utils.cost.CostCounter` sees every collective the
  step issues at dispatch and files it under the reference's HLO kind
  (:func:`collective_kind`: ``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``) with its output bytes, as the
  reference sums each collective's output shape.

Calls are recorded as they run, so loop trip counts are exact and
``unknown_trips`` is always False.
"""
from __future__ import annotations

# aten-level op names (``utils.cost._name``: the in-place underscore
# dropped) of the functional collectives DTensor issues, of the c10d ops
# behind an explicit torch.distributed call, and of DTensor's all-to-all
# op -> the reference's HLO kind
HLO_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather": "all-gather", "allgather_into_tensor_coalesced":
        "all-gather", "_allgather_base": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base":
        "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base": "all-to-all",
    "alltoall": "all-to-all", "shard_dim_alltoall": "all-to-all",
}


def collective_kind(opname: str) -> str | None:
    """The reference's HLO kind of the collective op ``opname``, or None
    for any other op."""
    return HLO_KINDS.get(opname)


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
