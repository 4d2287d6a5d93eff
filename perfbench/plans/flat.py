"""The flat plan: one trajectory on one card, ``Engine(plan=None)`` with the
linked-cell table and its row reordering, as ``repro_torch``'s main path
runs it.

Every plan module gives the runner the same four calls: ``engine(kw)``,
``draws(eng, state, group)``, ``table(eng, group)`` and
``counters(eng)``.  ``group`` is the host-side process group of a run over
several cards (None here).
"""
from __future__ import annotations


def engine(kw: dict):
    from repro_torch.md.engine import Engine
    return Engine(**kw)


def draws(eng, state, group) -> list:
    """How the step just taken drew its noise: one ``(generator state
    before it, row -> atom map)``.  A rebuild sorts atoms into linked-cell
    order, and which atom takes which normal draw is the engine's free
    choice: row ``i`` went to atom ``perm[i]``."""
    carry = eng._carry
    perm = carry.perm.detach().cpu() if hasattr(carry, "perm") else None
    return [(state, perm)]


def table(eng, group) -> dict:
    """The engine's neighbor table in input atom order."""
    return {"idx": eng.table.idx.detach().cpu(),
            "mask": eng.table.mask.detach().cpu()}


def counters(eng) -> dict:
    return {"rebuilds": eng.n_rebuilds}
