"""The Sharded plan: one trajectory decomposed over the cards of a run, one
rank a card, ``Engine(plan=Sharded())`` with the plan's own choice of
mesh (one dimension over the ranks, sharding x), cell grid, cell capacity
and halo mode, as the paper's weak scaling runs it.

Each rank holds its slab of the cell-major ``(cx, cy, cz, K)`` slot layout
and draws its noise from its own generator over its slots; ``aid`` names
the atom in each slot (-1: empty).  The calls below gather what the check
needs from every rank to rank 0 over the run's host-side group and return
it there (None on the other ranks).
"""
from __future__ import annotations

import torch


def engine(kw: dict):
    from repro_torch.md.engine import Engine
    from repro_torch.parallel.plan import Sharded
    return Engine(plan=Sharded(), **kw)


def _gather(obj, group):
    import torch.distributed as dist
    out = ([None] * dist.get_world_size(group)
           if dist.get_rank(group) == 0 else None)
    dist.gather_object(obj, out, dst=0, group=group)
    return out


def draws(eng, state, group):
    """Every rank's ``(generator state before the step, slot -> atom map)``,
    in rank order, on rank 0."""
    aid = eng._carry.aid.detach().reshape(-1).cpu()
    return _gather((state, aid), group)


def _ext_atoms(eng, grid: torch.Tensor) -> torch.Tensor:
    """The atom in each slot of this rank's halo-extended block
    ``(cx + 2, cy + 2, cz + 2, K)``, flattened as the table indexes it, from
    the global ``(CX, CY, CZ, K)`` grid of atom ids."""
    rp = eng._rplan
    idx = [(torch.arange(c + 2) - 1 + o) % n for c, o, n in
           zip(rp.local_shape, rp.offsets, rp.dspec.cells)]
    return grid[idx[0]][:, idx[1]][:, :, idx[2]].reshape(-1)


def table(eng, group):
    """The ranks' tables in atom ids, ``{"idx" (N, M), "mask"}`` in input
    atom order, on rank 0: each slot's neighbor slots of the extended block
    mapped to the atoms in them through every rank's ``aid``."""
    import torch.distributed as dist
    rp = eng._rplan
    aid = eng._carry.aid.detach().cpu()
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, (rp.offsets, aid), group=group)
    grid = torch.full(tuple(rp.dspec.cells) + (aid.shape[-1],), -1,
                      dtype=aid.dtype)
    for off, a in parts:
        grid[off[0]:off[0] + a.shape[0], off[1]:off[1] + a.shape[1],
             off[2]:off[2] + a.shape[2]] = a
    nbh = eng._carry.nbh
    m = nbh.idx.shape[-1]
    rows = aid.reshape(-1).long()
    nbr = _ext_atoms(eng, grid)[nbh.idx.detach().cpu().reshape(-1, m).long()]
    mask = nbh.mask.detach().cpu().reshape(-1, m) & (nbr >= 0)
    own = rows >= 0
    rows, nbr, mask = rows[own], nbr[own], mask[own]
    nbr = torch.where(mask, nbr, rows[:, None])
    got = _gather((rows, nbr.to(torch.int32), mask), group)
    if got is None:
        return None
    n = sum(r.numel() for r, _, _ in got)
    idx = torch.empty((n, m), dtype=torch.int32)
    msk = torch.zeros((n, m), dtype=torch.bool)
    for r, i, k in got:
        idx[r], msk[r] = i, k
    return {"idx": idx, "mask": msk}


def counters(eng) -> dict:
    led = eng.halo_ledger
    return {"rebuilds": eng.n_rebuilds, "migrated": eng.n_migrated,
            "halo_bytes": sum(led.bytes.values()),
            "halo_exchanges": sum(led.counts.values())}
