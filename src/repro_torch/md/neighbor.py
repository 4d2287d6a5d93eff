"""Neighbor tables for short-range ML potentials (port of ``repro.md.neighbor``).

* ``dense_neighbor_table`` - O(N^2) masked all-pairs table (tests, small
  systems).
* ``cell_neighbor_table`` - linked-cell construction with a fixed per-cell
  capacity: bin atoms, search the 27-cell stencil, keep the ``capacity``
  nearest neighbors with ``torch.topk``.  Unlike the reference, which drops
  atoms silently when a cell overflows, this build checks the overflow flag
  and raises.

The gather -> compute split of the MD hot loop: ``gather_blocks`` packs the
table-static blocks (idx, mask, neighbor types) and the position-dependent
``dr`` into a :class:`Neighborhood`; ``refresh_dr`` refreshes only ``dr``
after a drift; potentials evaluate from the ``Neighborhood`` alone and
assemble atomic forces with ``assemble_pair_forces``.

Replica batches (the Replicated plan): crystalline replicas share one
table, built from :func:`reference_pos` (the replica-mean positions);
:func:`shared_blocks` keeps one copy of its static blocks and a per-replica
``dr`` (R, N, M, 3), which :func:`refresh_dr` refreshes for all replicas in
one gather; :func:`needs_rebuild` trips when any replica does, and
:func:`compute_replicas` runs a flat ``compute`` over the batch.

Deterministic reverse sums.  Two reductions run "backwards" through the
table: the pair reaction forces (atom k collects ``-g[i, m]`` from every
slot listing it) and the gradient of the neighbor-spin gather ``s[idx]``.
``index_add_`` does both with float atomics on a CUDA tensor, so two
identical runs could differ in the last bit.  Here both read the
table's transpose instead: :func:`reverse_index` lists, per atom, the flat
slots that point at it (a stable sort of ``idx``, built once per table),
and :func:`reverse_sum` gathers those slots and sums each row in a fixed
order.  ``gather_blocks(..., reverse=True)`` stores it in the
``Neighborhood``; ``assemble_pair_forces_plain`` keeps the ``index_add_``
form as the plain version it is held against.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch


class NeighborTable(NamedTuple):
    idx: torch.Tensor    # (N, M) int32 neighbor indices (self-padded)
    mask: torch.Tensor   # (N, M) bool
    r0: torch.Tensor     # (N, 3) positions at build time (for skin test)
    cutoff: float        # cutoff + skin used at build

    @property
    def capacity(self) -> int:
        return self.idx.shape[1]


def _min_image(dr: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return dr - box * torch.round(dr / box)


def dense_neighbor_table(pos: torch.Tensor, box: torch.Tensor, cutoff: float,
                         capacity: int, skin: float = 0.5) -> NeighborTable:
    """All-pairs table: up to ``capacity`` nearest neighbors inside
    cutoff+skin per atom (distance-sorted, so truncation drops the farthest).
    """
    n = pos.shape[0]
    rc = cutoff + skin
    dr = _min_image(pos[None, :, :] - pos[:, None, :], box)
    d2 = torch.sum(dr * dr, dim=-1)
    d2.fill_diagonal_(float("inf"))                  # exclude self
    neg = torch.where(d2 <= rc * rc, -d2, torch.full_like(d2, -float("inf")))
    vals, idx = torch.topk(neg, min(capacity, n), dim=1)
    mask = vals > -float("inf")
    if idx.shape[1] < capacity:                      # capacity > n
        pad = capacity - idx.shape[1]
        idx = torch.nn.functional.pad(idx, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    rows = torch.arange(n, device=pos.device)[:, None]
    idx = torch.where(mask, idx, rows)               # self-pad invalid slots
    return NeighborTable(idx=idx.to(torch.int32), mask=mask, r0=pos,
                         cutoff=rc)


def gather_neighbors(pos: torch.Tensor, spin: torch.Tensor,
                     types: torch.Tensor, table: NeighborTable,
                     box: torch.Tensor):
    """Per-neighbor quantities from a table: (dr (N,M,3) min-imaged
    r_j - r_i, dist (N,M), neighbor spins (N,M,3), neighbor types (N,M),
    mask (N,M)).  Differentiable in ``pos`` and ``spin`` (the whole-
    evaluation surfaces differentiate through it)."""
    idx = table.idx.long()
    dr = _min_image(pos[idx] - pos[:, None, :], box)
    dist = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-30)
    return dr, dist, spin[idx], types[idx], table.mask


def needs_rebuild(table: NeighborTable, pos: torch.Tensor, box: torch.Tensor,
                  skin: float = 0.5) -> torch.Tensor:
    """0-d bool tensor: did any atom (of any replica, for a (R, N, 3)
    batch) move more than skin/2 since the build?"""
    dr = _min_image(pos - table.r0, box)
    return torch.max(torch.sum(dr * dr, dim=-1)) > (skin * 0.5) ** 2


# ---------------------------------------------------------------------------
# Gather -> compute split (fused hot loop)
# ---------------------------------------------------------------------------

class Neighborhood(NamedTuple):
    """Pre-gathered neighbor blocks consumed by potential ``compute``.

    ``idx``/``mask``/``tj`` are table-static (valid until the next rebuild);
    ``dr`` depends on positions and is refreshed once per drift.
    """

    idx: torch.Tensor   # (N, M) int32 neighbor indices (self-padded)
    mask: torch.Tensor  # (N, M) bool
    tj: torch.Tensor    # (N, M) int32 neighbor types
    dr: torch.Tensor    # (N, M, 3) min-imaged r_j - r_i; (R, N, M, 3) shared
    rev: torch.Tensor | None = None   # (N, R) reverse_index(idx), or None


def reverse_index(idx: torch.Tensor) -> torch.Tensor:
    """The table's transpose: row k lists, in increasing order, the flat
    slots ``i * M + m`` with ``idx[i, m] == k`` (every slot, masked ones
    too), padded with ``N * M`` (a zero row in :func:`reverse_sum`).

    A stable sort of the flat table; R (the longest row) is read back
    once, so build it once per table, not per evaluation."""
    n, m = idx.shape
    flat = idx.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    target = flat[order]
    counts = torch.bincount(flat, minlength=n)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * m, device=idx.device) - start[target]
    rev = torch.full((n, max(int(counts.max()), 1)), n * m,
                     dtype=torch.int64, device=idx.device)
    rev[target, rank] = order
    return rev


def reverse_sum(vals: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """``out[k] = sum of vals[s]`` over the slots s of ``rev[k]``, each row
    summed in one fixed order: the deterministic form of
    ``zeros.index_add_(0, idx.flatten(), vals)``.  ``vals`` is (N*M, C)."""
    padded = torch.cat([vals, vals.new_zeros((1,) + vals.shape[1:])])
    return padded[rev].sum(dim=1)


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` whose gradient is :func:`reverse_sum` (autograd's own
    backward of an index gather accumulates with atomics on the card)."""

    @staticmethod
    def forward(ctx, x, idx, rev):
        ctx.save_for_backward(rev)
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (rev,) = ctx.saved_tensors
        tail = g.shape[2:]
        return reverse_sum(g.reshape((-1,) + tail), rev), None, None


def neighbor_rows(x: torch.Tensor, nbh: Neighborhood,
                  plain: bool = False) -> torch.Tensor:
    """``x[idx]`` (N, M, ...) for per-atom rows ``x``; differentiable, with
    a deterministic gradient unless ``plain``."""
    idx = nbh.idx.long()
    if plain or not (x.requires_grad and torch.is_grad_enabled()):
        return x[idx]
    rev = nbh.rev if nbh.rev is not None else reverse_index(nbh.idx)
    return _GatherRows.apply(x, idx, rev)


def _pair_dr(pos: torch.Tensor, idx: torch.Tensor,
             box: torch.Tensor) -> torch.Tensor:
    """Min-imaged ``r_j - r_i`` per slot, (..., N, M, 3) for positions
    (..., N, 3): one gather for every leading (replica) index."""
    return _min_image(pos[..., idx, :] - pos[..., :, None, :], box)


def gather_blocks(pos: torch.Tensor, types: torch.Tensor, table: NeighborTable,
                  box: torch.Tensor, reverse: bool = False) -> Neighborhood:
    """Full gather after a table (re)build; ``reverse`` also builds the
    table's transpose for the deterministic reverse sums."""
    idx = table.idx.long()
    return Neighborhood(idx=table.idx, mask=table.mask, tj=types[idx],
                        dr=_pair_dr(pos, idx, box),
                        rev=reverse_index(table.idx) if reverse else None)


def refresh_dr(nbh: Neighborhood, pos: torch.Tensor,
               box: torch.Tensor) -> Neighborhood:
    """Refresh only the position-dependent block (one gather per drift;
    positions (R, N, 3) refresh every replica's ``dr`` at once)."""
    return nbh._replace(dr=_pair_dr(pos, nbh.idx.long(), box))


def reference_pos(pos: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Replica-mean positions (R, N, 3) -> (N, 3), each atom's
    displacements min-imaged around replica 0: the crystalline reference a
    replica batch's shared table is built from."""
    p0 = pos[0]
    return p0 + torch.mean(_min_image(pos - p0, box), dim=0)


def shared_blocks(table: NeighborTable, types: torch.Tensor,
                  pos: torch.Tensor, box: torch.Tensor,
                  reverse: bool = False) -> Neighborhood:
    """A replica batch's blocks: one copy of the table's static blocks
    (``idx``/``mask``/``tj``, and its transpose with ``reverse``) for all
    replicas, and a per-replica ``dr`` (R, N, M, 3) from one batched
    gather of positions (R, N, 3); ``types`` (N,) is shared too."""
    if pos.dim() != 3:
        raise ValueError(f"shared_blocks takes replica-batched positions "
                         f"(R, N, 3), got {tuple(pos.shape)}")
    return gather_blocks(pos, types, table, box, reverse=reverse)


def compute_replicas(compute, nbh: Neighborhood, spin: torch.Tensor,
                     types: torch.Tensor, field=None):
    """A flat gather-once ``compute(nbh, spin, types, field)`` over a
    replica batch (``nbh.dr`` (R, N, M, 3), ``spin`` (R, N, 3), ``field``
    (R, 3) or None), one replica at a time in a Python loop:
    ``(E (R,), F (R, N, 3), H_eff (R, N, 3))``.  Each replica's numbers are
    the flat call's on its own inputs."""
    outs = [compute(nbh._replace(dr=nbh.dr[r]), spin[r], types,
                    None if field is None else field[r])
            for r in range(spin.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def compute_from_blocks(etot, nbh: Neighborhood, spin: torch.Tensor,
                        plain: bool = False):
    """``etot(dr, spin, rows) -> ()`` differentiated by autograd into
    ``(E, F, H_eff)``: forces assembled from dE/ddr by the pair reverse sum,
    the effective field as -dE/dS.  ``etot`` gathers neighbor rows with
    ``rows(x)``, so the spin gather's gradient is deterministic too;
    ``plain`` uses ``index_add_`` and autograd's gather gradient instead
    (the plain version the deterministic one is held against)."""
    if not plain and nbh.rev is None:
        nbh = nbh._replace(rev=reverse_index(nbh.idx))
    dr = nbh.dr.detach().requires_grad_(True)
    s = spin.detach().requires_grad_(True)
    with torch.enable_grad():
        e = etot(dr, s, lambda x: neighbor_rows(x, nbh, plain))
        g_dr, g_s = torch.autograd.grad(e, (dr, s), allow_unused=True)
    if g_s is None:             # a spin-free potential
        g_s = torch.zeros_like(spin)
    assemble = assemble_pair_forces_plain if plain else assemble_pair_forces
    return e.detach(), assemble(g_dr, nbh), -g_s


def assemble_pair_forces(g_dr: torch.Tensor, nbh: Neighborhood) -> torch.Tensor:
    """Atomic forces from dE/ddr (N, M, 3): atom i feels ``+sum_m g[i,m]``
    and the reaction ``-g[k,m]`` from every pair (k, m) listing it, summed
    deterministically through the table's transpose."""
    g = torch.where(nbh.mask[..., None], g_dr, torch.zeros_like(g_dr))
    rev = nbh.rev if nbh.rev is not None else reverse_index(nbh.idx)
    return torch.sum(g, dim=1) - reverse_sum(g.reshape(-1, g.shape[-1]), rev)


def assemble_pair_forces_plain(g_dr: torch.Tensor,
                               nbh: Neighborhood) -> torch.Tensor:
    """:func:`assemble_pair_forces` with the reaction scattered by
    ``index_add_`` (float atomics on the card: not bitwise reproducible)."""
    g = torch.where(nbh.mask[..., None], g_dr, torch.zeros_like(g_dr))
    direct = torch.sum(g, dim=1)
    react = torch.zeros_like(direct).index_add_(
        0, nbh.idx.reshape(-1).long(), g.reshape(-1, g.shape[-1]))
    return direct - react


# ---------------------------------------------------------------------------
# Linked-cell construction (scalable path)
# ---------------------------------------------------------------------------

def _cell_coords(pos: torch.Tensor, box: torch.Tensor,
                 n_cells: tuple[int, int, int]):
    """Per-atom integer cell coordinates (ci, cj, ck) and flat cell id."""
    cx, cy, cz = n_cells
    frac = pos / box
    ci = torch.clamp((frac[:, 0] * cx).to(torch.int64), 0, cx - 1)
    cj = torch.clamp((frac[:, 1] * cy).to(torch.int64), 0, cy - 1)
    ck = torch.clamp((frac[:, 2] * cz).to(torch.int64), 0, cz - 1)
    return ci, cj, ck, (ci * cy + cj) * cz + ck


def grid_shape(box, cutoff: float, skin: float = 0.5) -> tuple[int, int, int]:
    """Linked-cell grid dims for a box (host array or tensor): cells at least
    cutoff+skin wide.  Callers use the dense table when any dim is < 3."""
    box = np.asarray(box.cpu() if isinstance(box, torch.Tensor) else box)
    rc = cutoff + skin
    return tuple(int(x) for x in np.maximum(np.floor(box / rc), 1).astype(int))


def make_table_builder(box, cutoff: float, capacity: int,
                       cell_capacity: int = 24, skin: float = 0.5,
                       use_cell_list: bool = True):
    """``(build, n_cells, use_cell)`` for a fixed box: the linked-cell build
    with pinned grid dims when the box fits the 27-stencil (and
    ``use_cell_list``), else the dense table."""
    n_cells = grid_shape(box, cutoff, skin)
    use_cell = use_cell_list and min(n_cells) >= 3
    if use_cell:
        build = partial(cell_neighbor_table, cutoff=cutoff, capacity=capacity,
                        cell_capacity=cell_capacity, skin=skin,
                        n_cells=n_cells)
    else:
        build = partial(dense_neighbor_table, cutoff=cutoff,
                        capacity=capacity, skin=skin)
    return build, n_cells, use_cell


def cell_order(pos: torch.Tensor, box: torch.Tensor,
               n_cells: tuple[int, int, int]) -> torch.Tensor:
    """Stable permutation sorting atoms by linked-cell bin (cell-major rows),
    so each atom's stencil neighborhood is near-contiguous in memory."""
    *_, flat = _cell_coords(pos, box, n_cells)
    return torch.argsort(flat, stable=True)


def bin_atoms(pos: torch.Tensor, box: torch.Tensor,
              n_cells: tuple[int, int, int], capacity: int):
    """Scatter atoms into a (cx, cy, cz, capacity) cell grid.

    Returns (cell_idx int32 atom ids or -1, cell_mask, overflow 0-d bool).
    Atom order inside a cell is arrival order; atoms past ``capacity`` are
    left out of the grid and flagged.
    """
    cx, cy, cz = n_cells
    *_, flat = _cell_coords(pos, box, n_cells)
    n = pos.shape[0]
    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order]
    ar = torch.arange(n, device=pos.device)
    idx_in_run = ar - torch.searchsorted(sorted_flat, sorted_flat, side="left")
    slot = torch.empty_like(idx_in_run).scatter_(0, order, idx_in_run)
    overflow = torch.any(slot >= capacity)
    keep = slot < capacity
    grid = torch.full((cx * cy * cz * capacity,), -1, dtype=torch.int32,
                      device=pos.device)
    grid[flat[keep] * capacity + slot[keep]] = ar[keep].to(torch.int32)
    grid = grid.reshape(cx, cy, cz, capacity)
    return grid, grid >= 0, overflow


_STENCIL = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1)]


def cell_neighbor_table(pos: torch.Tensor, box: torch.Tensor, cutoff: float,
                        capacity: int, cell_capacity: int = 24,
                        skin: float = 0.5,
                        n_cells: tuple[int, int, int] | None = None,
                        ) -> NeighborTable:
    """Linked-cell neighbor table: bin into cells >= cutoff+skin wide, search
    the 27-cell stencil, keep the ``capacity`` nearest neighbors.

    Raises ``RuntimeError`` when a cell holds more than ``cell_capacity``
    atoms (the reference drops them silently).
    """
    if n_cells is None:
        n_cells = grid_shape(box, cutoff, skin)
        if min(n_cells) < 3:
            return dense_neighbor_table(pos, box, cutoff, capacity, skin)
    elif min(n_cells) < 3:
        raise ValueError(f"n_cells {n_cells} too small for the 27-stencil; "
                         "use dense_neighbor_table")
    rc = cutoff + skin
    cx, cy, cz = n_cells
    grid, _, overflow = bin_atoms(pos, box, n_cells, cell_capacity)
    if bool(overflow):
        raise RuntimeError(
            f"linked-cell overflow: a cell of the {n_cells} grid holds more "
            f"than cell_capacity={cell_capacity} atoms; raise cell_capacity")
    n = pos.shape[0]
    dev = pos.device
    ci, cj, ck, _ = _cell_coords(pos, box, n_cells)
    offs = torch.tensor(_STENCIL, dtype=torch.int64, device=dev)   # (27, 3)
    sci = (ci[:, None] + offs[None, :, 0]) % cx
    scj = (cj[:, None] + offs[None, :, 1]) % cy
    sck = (ck[:, None] + offs[None, :, 2]) % cz
    cand = grid[sci, scj, sck].reshape(n, -1).long()   # (N, 27K)
    valid = cand >= 0
    cand_safe = torch.where(valid, cand, torch.zeros_like(cand))
    dr = _min_image(pos[cand_safe] - pos[:, None, :], box)
    d2 = torch.sum(dr * dr, dim=-1)
    rows = torch.arange(n, device=dev)[:, None]
    good = valid & (d2 <= rc * rc) & (cand != rows)
    neg = torch.where(good, -d2, torch.full_like(d2, -float("inf")))
    k = min(capacity, neg.shape[1])
    vals, sel = torch.topk(neg, k, dim=1)
    mask = vals > -float("inf")
    idx = torch.where(mask, torch.gather(cand_safe, 1, sel), rows)
    if k < capacity:
        pad = capacity - k
        idx = torch.cat([idx, rows.expand(n, pad)], dim=1)
        mask = torch.nn.functional.pad(mask, (0, pad))
    return NeighborTable(idx=idx.to(torch.int32), mask=mask, r0=pos,
                         cutoff=rc)
