"""Spatial domain decomposition of the coupled spin-lattice system (port of
``repro.parallel.domain``): the sharded fused loop's pieces, and the legacy
per-evaluation paths (27-stencil and pruned-table autograd, and K1 -> q_Fp
halo -> K2) at the end of the module.

State layout: cell-major tensors ``(cx, cy, cz, K, ...)`` - a global grid of
link cells (each at least cutoff+skin wide) with a fixed per-cell atom
capacity K; ``types == -1`` marks an empty slot.  The grid's spatial dims
are sharded over the mesh: each rank (one process, one device) owns a
rectangular slab of cells, as one MPI rank's sub-domain in the paper's
LAMMPS implementation.

Row spaces.  A rank's ``n_slots = cx*cy*cz*K`` owned slots, flattened
cell-major, and the halo-extended block ``(cx+2, cy+2, cz+2, K)``
("ext-flat").  The neighbor table ``idx`` indexes ext-flat slots.  K2 reads
neighbor adjoint rows through its index, with row ``i`` its own atom's, so
the kernel path renumbers the table once per rebuild into a *local-first*
row space: rows ``0..n_slots-1`` are the owned slots, the halo ring follows
(:func:`local_first_index`).

Local replicas (the Sharded plan with ``replicas > 0``): every block may
carry a leading replica axis, ``(R, cx, cy, cz, K, ...)``.  Each replica
migrates its own atoms and builds its own table; every halo round carries
all local replicas in one message (the cell dims are dims 1-3); K1 and K2
launch once for all of them, each on its own table
(:func:`make_domain_kernel_evaluator`).  A replica's numbers are its flat
evaluation's: float sums over a replica's slots run per replica.

Reverse sums over the ext-flat rows (the pair reactions and neighbor-spin
gradients scattered onto ghosts) go through the table's transpose
(:func:`repro_torch.md.neighbor.reverse_index` / ``reverse_sum``), never
``index_add_``, whose float atomics on the card would break bitwise resume.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.md.neighbor import reverse_index, reverse_sum
from repro_torch.parallel.halo import (cell_dims, exchange_halo,
                                       exchange_halo_multi, fold_halo,
                                       fold_halo_multi, local_wrap)
from repro_torch.parallel.overlap import shell_slabs
from repro_torch.telemetry.profiling import host_sync
from repro_torch.utils import units


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """Static description of the decomposition."""

    cells: tuple[int, int, int]          # global link-cell grid (CX, CY, CZ)
    capacity: int                        # atoms per cell (K)
    cutoff: float
    box: tuple[float, float, float]      # global box [A]
    # mesh dimension sharding each spatial dim (None = local)
    axis_map: tuple = ("sx", None, None)
    skin: float = 0.0                    # neighbor-list skin [A]

    @property
    def rc(self) -> float:
        """Neighbor-table reach: cutoff + skin."""
        return self.cutoff + self.skin

    def check(self):
        for b, c in zip(self.box, self.cells):
            if b / c < self.rc:
                raise ValueError(f"cell size {b / c:.3f} < cutoff+skin "
                                 f"{self.rc}; the stencil would miss "
                                 "neighbors")

    def check_loop(self, mesh_shape: dict):
        """The sharded loop's invariants: every global dim >= 3 (the 27
        stencil cells are distinct) and sharded dims divisible by their
        mesh dimension (``mesh_shape``: {name: size})."""
        self.check()
        if min(self.cells) < 3:
            raise ValueError(f"global cell grid {self.cells} too small for "
                             "the 27-stencil")
        for d, name in enumerate(self.axis_map):
            if name is not None and self.cells[d] % mesh_shape[name]:
                raise ValueError(f"cells[{d}]={self.cells[d]} not divisible "
                                 f"by mesh dimension {name}="
                                 f"{mesh_shape[name]}")

    def local_shape(self, mesh_shape: dict) -> tuple[int, int, int]:
        """Per-rank cell-grid dims."""
        return tuple(c // (mesh_shape[name] if name is not None else 1)
                     for c, name in zip(self.cells, self.axis_map))


class DomainState(NamedTuple):
    """Cell-binned state (positions are GLOBAL coordinates)."""

    pos: torch.Tensor    # (CX, CY, CZ, K, 3)
    vel: torch.Tensor    # (CX, CY, CZ, K, 3)
    spin: torch.Tensor   # (CX, CY, CZ, K, 3)
    types: torch.Tensor  # (CX, CY, CZ, K) int32, -1 = empty slot
    mask: torch.Tensor   # (CX, CY, CZ, K) bool


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def pack_domain(spec: DomainSpec, pos, vel, spin, types,
                extras: dict | None = None):
    """Host-side binning of flat atom arrays into the global cell grid
    (CPU tensors; arrival order within a cell).

    ``extras`` maps name -> (N, ...) array binned alongside (filled with
    -1), e.g. the original atom ids; then returns ``(DomainState,
    {name: packed})``."""
    pos = _host(pos)
    box = np.asarray(spec.box)
    cells = np.asarray(spec.cells)
    ci = np.clip((pos / box * cells).astype(np.int64), 0, cells - 1)
    flat = (ci[:, 0] * spec.cells[1] + ci[:, 1]) * spec.cells[2] + ci[:, 2]
    order = np.argsort(flat, kind="stable")
    k = spec.capacity
    n_cells = int(np.prod(cells))
    counts = np.bincount(flat, minlength=n_cells)
    if counts.max() > k:
        raise ValueError(f"cell overflow: max {counts.max()} > capacity {k}")
    slot = np.zeros(pos.shape[0], np.int64)
    slot[order] = np.arange(pos.shape[0]) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)

    def scatter(a, fill):
        a = _host(a)
        out = np.full((n_cells * k, *a.shape[1:]), fill, a.dtype)
        out[flat * k + slot] = a
        return torch.from_numpy(out.reshape(*spec.cells, k, *a.shape[1:]))

    state = DomainState(pos=scatter(pos, 0.0), vel=scatter(vel, 0.0),
                        spin=scatter(spin, 0.0), types=scatter(types, -1),
                        mask=scatter(np.ones(pos.shape[0], bool), False))
    if extras is None:
        return state
    return state, {name: scatter(a, -1) for name, a in extras.items()}


def unpack_domain(state: DomainState):
    """Flatten back to host (N, ...) arrays, dropping empty slots (cell
    order)."""
    sel = np.nonzero(_host(state.mask).reshape(-1))[0]

    def flat(a, tail):
        return _host(a).reshape(-1, *tail)[sel]
    return (flat(state.pos, (3,)), flat(state.vel, (3,)),
            flat(state.spin, (3,)), flat(state.types, ()))


def unbin_cells(aid, *arrays):
    """Host-side inverse of the binning, in ORIGINAL atom order: ``aid`` is
    the (CX, CY, CZ, K) original-atom-id block (-1 = empty), each of
    ``arrays`` a cell-blocked (CX, CY, CZ, K, ...) field; returns their
    (N, ...) forms ordered by atom id."""
    aidf = _host(aid).reshape(-1)
    sel = np.nonzero(aidf >= 0)[0]
    order = np.empty(sel.size, np.int64)
    order[aidf[sel]] = sel
    outs = []
    for a in arrays:
        a = _host(a)
        outs.append(a.reshape(-1, *a.shape[4:])[order])
    return tuple(outs)


# 27-point stencil shifts
_SHIFTS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]


# ---------------------------------------------------------------------------
# the sharded fused loop's pieces
# ---------------------------------------------------------------------------

def _ext_flat_index(local_shape: tuple[int, int, int], k: int, device):
    """Candidate bookkeeping for the 27-stencil over the halo-extended grid.

    Returns (cand, own, shift_id):
      cand  (cx, cy, cz, 27*K) int64 - ext-flat slot index of every stencil
            candidate of each cell;
      own   (cx, cy, cz, K) int64    - each slot's own ext-flat index;
      shift_id (27*K,) int64         - which of the 27 shifts a candidate
            column came from (pairing with ``_SHIFTS``).
    """
    cx, cy, cz = local_shape
    ex_cy, ex_cz = cy + 2, cz + 2

    def cell_flat(ix, iy, iz):
        return (ix * ex_cy + iy) * ex_cz + iz

    ar = lambda n: torch.arange(n, device=device)
    gx, gy, gz = torch.meshgrid(ar(cx), ar(cy), ar(cz), indexing="ij")
    offs = torch.tensor(_SHIFTS, dtype=torch.int64, device=device)
    nb_cell = cell_flat(gx[..., None] + 1 + offs[:, 0],
                        gy[..., None] + 1 + offs[:, 1],
                        gz[..., None] + 1 + offs[:, 2])        # (...,27)
    cand = (nb_cell[..., :, None] * k + ar(k)).reshape(cx, cy, cz, 27 * k)
    own = cell_flat(gx + 1, gy + 1, gz + 1)[..., None] * k + ar(k)
    shift_id = torch.repeat_interleave(ar(27), k)
    return cand, own, shift_id


def local_first_index(local_shape: tuple[int, int, int], k: int, device):
    """The local-first renumbering of the ext-flat rows: ``(ext_to_lf
    (n_ext,), ring (n_ring,))`` - the owned slots, cell-major, become rows
    ``0..n_slots-1`` and the halo ring's ext-flat slots, in increasing
    order, the rows after them."""
    cx, cy, cz = local_shape
    n_ext = (cx + 2) * (cy + 2) * (cz + 2) * k
    _, own, _ = _ext_flat_index(local_shape, k, device)
    own = own.reshape(-1)
    is_own = torch.zeros(n_ext, dtype=torch.bool, device=device)
    is_own[own] = True
    ring = torch.nonzero(~is_own).reshape(-1)
    ext_to_lf = torch.empty(n_ext, dtype=torch.int64, device=device)
    ext_to_lf[own] = torch.arange(own.numel(), device=device)
    ext_to_lf[ring] = own.numel() + torch.arange(ring.numel(), device=device)
    return ext_to_lf, ring


def _min_image(dr, box):
    return dr - box * torch.round(dr / box)


# candidate pair entries (slots x 27K) per chunk of cells in
# build_local_table: bounds its (chunk, K, 27K, 3) temporaries
TABLE_CHUNK_PAIRS = 1 << 26


def _lead(types: torch.Tensor) -> int:
    """Leading batch dims of a cell block: 1 for (R, cx, cy, cz, K), 0 for
    (cx, cy, cz, K)."""
    return types.dim() - 4


def per_replica(fn, lead: int, *blocks):
    """``fn(*blocks)`` on flat blocks, or for a leading replica axis on each
    replica's blocks, the outputs stacked (a tuple of outputs, or one)."""
    if not lead:
        return fn(*blocks)
    outs = [fn(*(b[r] for b in blocks)) for r in range(blocks[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def slot_sum(x: torch.Tensor, lead: int) -> torch.Tensor:
    """The sum over a block's slots; with a leading replica axis each
    replica's, taken on a fresh copy of its rows so the reduction runs as
    on a flat block of that size (its order, and its bits, the flat
    one's)."""
    if not lead:
        return torch.sum(x)
    return per_replica(lambda r: torch.sum(r.clone()), lead, x)


def build_local_table(dspec: DomainSpec, axes, local_shape, capacity: int,
                      pos, types, allgather: bool = False):
    """Per-rank pruned neighbor table.

    Enumerates each owned atom's 27-stencil candidates in the halo-extended
    block, keeps the ``capacity`` nearest within cutoff+skin (top-k, as
    the flat tables) and returns the cell-major table ``(idx (cx,cy,cz,K,M)
    int32 into the ext-flat slots - self-padded where invalid, mask, tj
    neighbor types)``.  One fused (pos, types) halo round, for every local
    replica at once (a leading replica axis gives each replica its own
    table, with that axis).  Cells are processed in chunks of about
    ``TABLE_CHUNK_PAIRS`` candidate pairs, so the (cells, K, 27K, 3)
    candidate block never exists whole."""
    lead = _lead(types)
    ext = exchange_halo_multi({"pos": pos, "types": types}, axes,
                              tag="rebuild", allgather=allgather, lead=lead)
    return per_replica(
        lambda p, t, ep, et: _local_table(dspec, local_shape, capacity, p, t,
                                          ep, et),
        lead, pos, types, ext["pos"], ext["types"])


def _local_table(dspec, local_shape, capacity, pos, types, ext_pos,
                 ext_types):
    """One replica's table from its halo-extended (pos, types)."""
    cx, cy, cz = local_shape
    k = types.shape[3]
    box = torch.as_tensor(dspec.box, dtype=pos.dtype, device=pos.device)
    rc = dspec.rc
    exf_pos = ext_pos.reshape(-1, 3)
    exf_typ = ext_types.reshape(-1)
    cand, own, _ = _ext_flat_index(local_shape, k, pos.device)
    n_cells = cx * cy * cz
    cand, own = cand.reshape(n_cells, 27 * k), own.reshape(n_cells, k)
    posc, occ = pos.reshape(n_cells, k, 3), (types >= 0).reshape(n_cells, k)
    m_cap = min(capacity, 27 * k)
    step = max(1, TABLE_CHUNK_PAIRS // (k * 27 * k))
    idxs, masks = [], []
    for lo in range(0, n_cells, step):
        c = slice(lo, min(lo + step, n_cells))
        cc = cand[c]
        dr = _min_image(exf_pos[cc][:, None, :, :] - posc[c][:, :, None, :],
                        box)                              # (C, K, 27K, 3)
        d2 = torch.sum(dr * dr, dim=-1)
        good = ((exf_typ[cc] >= 0)[:, None, :]
                & (cc[:, None, :] != own[c][:, :, None])
                & (d2 <= rc * rc) & occ[c][:, :, None])
        neg = torch.where(good, -d2, torch.full_like(d2, -float("inf")))
        del dr, d2, good
        vals, sel = torch.topk(neg, m_cap, dim=-1)        # (C, K, M)
        mask = vals > -float("inf")
        idx = torch.gather(cc[:, None, :].expand(-1, k, -1), 2, sel)
        idxs.append(torch.where(mask, idx, own[c][..., None]))
        masks.append(mask)
    idx = torch.cat(idxs).reshape(cx, cy, cz, k, m_cap)
    mask = torch.cat(masks).reshape(cx, cy, cz, k, m_cap)
    tj = torch.where(mask, exf_typ[idx], torch.zeros_like(idx))
    return idx.to(torch.int32), mask, tj.to(torch.int32)


def migrate_cells(dspec: DomainSpec, axes, local_shape, offsets, pos, vel,
                  spin, types, aid, allgather: bool = False):
    """Re-bin every atom into its current cell, moving emigrants to the
    neighbouring rank that owns their new cell.

    Between rebuilds atoms move less than the skin, so the new cell lies
    in the 27-stencil of the old one: ONE fused multi-field halo round
    makes every migrating atom visible to its new owner, and each target
    cell packs its claimants in stencil order (a cumulative sum over the
    shift-major candidates; overflowing claimants go to a discarded dump
    column).  ``offsets`` are this rank's first global cell per dim.  With
    a leading replica axis every replica migrates its own atoms; the halo
    round carries them all.

    Returns (pos, vel, spin, types, aid, n_moved, n_dropped), the counts
    this rank's (0-d tensors over all its replicas, not yet reduced):
    n_moved owned atoms that changed cell; n_dropped atoms lost to a full
    cell plus atoms that moved further than one cell (a skin violation).
    The engine reduces them and fails loudly at the chunk boundary."""
    cx, cy, cz = local_shape
    lead = _lead(types)
    dtype, dev = pos.dtype, pos.device
    box = torch.as_tensor(dspec.box, dtype=dtype, device=dev)
    cells = torch.as_tensor(dspec.cells, dtype=torch.int64, device=dev)
    occ = types >= 0

    newc = torch.floor(pos / box * cells.to(dtype)).to(torch.int64)
    newc = torch.minimum(torch.clamp(newc, min=0), cells - 1)   # fp edge
    ar = lambda n, o: torch.arange(n, device=dev) + o
    gx, gy, gz = torch.meshgrid(ar(cx, offsets[0]), ar(cy, offsets[1]),
                                ar(cz, offsets[2]), indexing="ij")
    ownc = torch.stack([g[..., None].expand(types.shape)
                        for g in (gx, gy, gz)], dim=-1)

    # minimum-image cell displacement on the periodic global grid
    delta = torch.remainder(newc - ownc, cells)
    delta = torch.where(delta > cells // 2, delta - cells, delta)
    in_reach = torch.all(torch.abs(delta) <= 1, dim=-1) & occ
    moved = in_reach & torch.any(delta != 0, dim=-1)
    n_moved = torch.sum(moved.to(torch.int64))
    n_out_of_reach = torch.sum((occ & ~in_reach).to(torch.int64))
    # -1: not claimable (empty slot, or a skin-violating jump)
    enc = torch.where(in_reach, ((delta[..., 0] + 1) * 3 + (delta[..., 1] + 1))
                      * 3 + (delta[..., 2] + 1), torch.full_like(delta[..., 0],
                                                                 -1))
    ext = exchange_halo_multi(
        {"pos": pos, "vel": vel, "spin": spin, "types": types, "aid": aid,
         "enc": enc}, axes, tag="migrate", allgather=allgather, lead=lead)
    names = ("pos", "vel", "spin", "types", "aid", "enc")
    out = per_replica(lambda *e: _claim(local_shape, types.shape[-1],
                                        dict(zip(names, e))),
                      lead, *(ext[k] for k in names))
    return (*out[:5], n_moved, torch.sum(out[5]) + n_out_of_reach)


def _claim(local_shape, k: int, ext: dict):
    """One replica's cells claim the atoms of its halo-extended block whose
    displacement points at them; returns (pos, vel, spin, types, aid,
    n_overflow)."""
    cx, cy, cz = local_shape
    n_cells = cx * cy * cz
    dtype, dev = ext["pos"].dtype, ext["pos"].device
    cand, _, shift_id = _ext_flat_index(local_shape, k, dev)
    cand = cand.reshape(n_cells, 27 * k)
    cand_enc = ext["enc"].reshape(-1)[cand]
    # a candidate seen through stencil shift s belongs here iff its cell
    # displacement is exactly -s
    offs27 = torch.tensor(_SHIFTS, dtype=torch.int64, device=dev)
    want = (((-offs27[:, 0] + 1) * 3 + (-offs27[:, 1] + 1)) * 3
            + (-offs27[:, 2] + 1))
    belongs = cand_enc == want[shift_id][None, :]
    rank = torch.cumsum(belongs.to(torch.int64), dim=-1) - 1
    slot = torch.where(belongs & (rank < k), rank, torch.full_like(rank, k))
    n_overflow = torch.sum((belongs & (rank >= k)).to(torch.int64))

    payload = torch.cat(
        [ext["pos"].reshape(-1, 3), ext["vel"].reshape(-1, 3),
         ext["spin"].reshape(-1, 3),
         ext["types"].reshape(-1, 1).to(dtype),
         ext["aid"].reshape(-1, 1).to(dtype)], dim=-1)[cand]
    nf = payload.shape[-1]
    rows = torch.arange(n_cells, device=dev)[:, None].expand(-1, 27 * k)
    # every claimant past a cell's capacity, and every candidate that does
    # not belong, lands in column k, which is discarded: duplicate writes
    # happen only there
    out = torch.zeros((n_cells, k + 1, nf), dtype=dtype, device=dev)
    out[rows.reshape(-1), slot.reshape(-1)] = payload.reshape(-1, nf)
    got = torch.zeros((n_cells, k + 1), dtype=torch.bool, device=dev)
    got[rows.reshape(-1), slot.reshape(-1)] = belongs.reshape(-1)
    out, got = out[:, :k], got[:, :k]

    def field(lo):
        a = out[..., lo:lo + 3].reshape(cx, cy, cz, k, 3)
        return torch.where(got.reshape(cx, cy, cz, k, 1), a,
                           torch.zeros_like(a))

    def ids(col):
        return torch.where(got, torch.round(out[..., col]).to(torch.int32),
                           torch.full_like(got, -1, dtype=torch.int32)
                           ).reshape(cx, cy, cz, k)

    return field(0), field(3), field(6), ids(9), ids(10), n_overflow


class DomainNbh(NamedTuple):
    """Per-rank pruned-table blocks of the sharded loop.

    ``idx``/``mask``/``tj`` (and ``rev``, ``lf``) are table-static, valid
    until the next rebuild; ``dr`` (and, on the fused-gather path, the
    neighbor-spin block ``sj``) is refreshed by ONE fused halo exchange
    per drift.  The cell-major twin of
    :class:`repro_torch.md.neighbor.Neighborhood`; with local replicas
    every block has a leading replica axis (``rev`` is then one transpose
    per replica)."""

    idx: torch.Tensor   # (cx, cy, cz, K, M) int32 into ext-flat slots
    mask: torch.Tensor  # (cx, cy, cz, K, M) bool
    tj: torch.Tensor    # (cx, cy, cz, K, M) int32 neighbor types
    dr: torch.Tensor    # (cx, cy, cz, K, M, 3) min-imaged pair vectors
    sj: torch.Tensor | None = None   # (..., M, 3) neighbor spins, or None
                                     # when spins are exchanged per
                                     # evaluation
    rev: torch.Tensor | None = None  # reverse_index over the ext-flat rows
    lf: torch.Tensor | None = None   # (n_slots, M) int32 local-first idx


def replica_nbh(nbh: DomainNbh, r: int) -> DomainNbh:
    """Replica ``r``'s blocks of a replica-batched :class:`DomainNbh`."""
    pick = lambda x: None if x is None else x[r]
    return DomainNbh(*(pick(x) for x in nbh))


def _rows(src: torch.Tensor, idx: torch.Tensor, lead: int) -> torch.Tensor:
    """Gather the (..., 3) rows ``idx`` of a halo-extended block, per
    replica with a leading replica axis."""
    if not lead:
        return src.reshape(-1, 3)[idx]
    r = torch.arange(src.shape[0], device=idx.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    return src.reshape(src.shape[0], -1, 3)[r, idx]


def _gather_blocks(pending, idx, slabs, local_of, gather, lead: int = 0):
    """Run ``gather(src, sl) -> {name: block}`` over the slabs: from the
    exchange's result when no other rank takes part, else the interior
    slab from the local wrap (``local_of()``) before waiting for the
    exchange, the shell after it.  ``sl`` indexes the cell dims after
    ``lead`` batch dims.  Returns {name: full block}."""
    pre = (slice(None),) * lead
    if not pending.communicates:
        return gather(pending.wait(), pre + (slice(None),) * 3)
    parts = [(pre + sl, gather(local_of(), pre + sl))
             for sl, inner in slabs if inner]
    ext = pending.wait()
    parts += [(pre + sl, gather(ext, pre + sl))
              for sl, inner in slabs if not inner]
    out = {name: torch.empty(idx.shape + blk.shape[idx.dim():],
                             dtype=blk.dtype, device=blk.device)
           for name, blk in parts[0][1].items()}
    for sl, blocks in parts:
        for name, blk in blocks.items():
            out[name][sl] = blk
    return out


def make_domain_refresh(dspec: DomainSpec, axes, local_shape,
                        spin_in_gather: bool = True,
                        allgather: bool = False):
    """THE one halo exchange per drift: ``refresh(pos, nbh[, spin], tag)
    -> nbh`` packs boundary positions (and, with ``spin_in_gather``, spins)
    into one fused round - every local replica in the same message - then
    gathers the min-imaged pair vectors (and neighbor spins) through the
    table.  The interior slab gathers from the local wrap while the
    exchange is in flight (:mod:`repro_torch.parallel.overlap`)."""
    slabs = shell_slabs(local_shape)
    boxt = tuple(dspec.box)

    def refresh(pos, nbh: DomainNbh, spin=None, tag: str = "drift-pos"
                ) -> DomainNbh:
        lead = pos.dim() - 5
        fields = {"pos": pos}
        if spin_in_gather and spin is not None:
            fields["spin"] = spin
        with host_sync():    # a blocking copy to the card
            box = torch.as_tensor(boxt, dtype=pos.dtype, device=pos.device)
        pending = exchange_halo_multi(fields, axes, tag=tag,
                                      allgather=allgather, async_op=True,
                                      lead=lead)

        def gather(src, sl):
            idx = nbh.idx[sl].long()
            out = {"dr": _min_image(_rows(src["pos"], idx, lead)
                                    - pos[sl][..., None, :], box)}
            if "spin" in src:
                out["sj"] = _rows(src["spin"], idx, lead)
            return out

        got = _gather_blocks(
            pending, nbh.idx, slabs,
            lambda: {k: local_wrap(v, dims=cell_dims(lead))
                     for k, v in fields.items()}, gather, lead)
        return nbh._replace(dr=got["dr"], sj=got.get("sj", nbh.sj))

    return refresh


def _zeeman_moments(potential, ti, occ, like):
    mom = potential.site_moments(ti).to(device=like.device)
    return torch.where(occ, mom, torch.zeros_like(mom)).to(like.dtype)


def _field_block(field, like: torch.Tensor, lead: int) -> torch.Tensor:
    """A field as a tensor broadcasting over a block's (..., 3) rows: (3,),
    or per replica (R, 3) against a leading replica axis."""
    b = torch.as_tensor(field, dtype=like.dtype, device=like.device)
    if lead and b.dim() == 2:
        b = b.reshape((b.shape[0],) + (1,) * (like.dim() - 2) + (3,))
    return b


def _zeeman_energy(mom, spin, b, lead: int) -> torch.Tensor:
    return units.MU_B * slot_sum(mom[..., None] * spin * b, lead)


def make_domain_evaluator(potential, dspec: DomainSpec, axes, local_shape,
                          spin_in_gather: bool = True,
                          allgather: bool = False):
    """Per-rank ``(refresh, compute)`` of the sharded loop for a potential
    with the ``pair_energies`` / ``site_moments`` surface.

    ``compute(nbh, spin, types, field) -> (E_local, F, H_eff)`` evaluates
    from the gathered blocks by autograd (each local replica in turn); the
    reaction forces and the neighbor-spin gradients scattered onto ext
    slots (a deterministic reverse sum) fold back to their owners in ONE
    adjoint round for every local replica
    (:func:`repro_torch.parallel.halo.fold_halo_multi`, tag ``"adjoint"``).
    The energy stays rank-local ((R,) with local replicas): the engine
    folds its reduction into the per-step scalar one.

    ``spin_in_gather=True`` reads the neighbor spins the drift refresh
    gathered (exact when a step evaluates once at fixed spins);
    self-consistent midpoint iterations evaluate at updated spins, so
    there ``compute`` re-exchanges spin ghosts (tag ``"spin"``) each
    evaluation, the interior slab from the local wrap while the exchange
    is in flight."""
    cx, cy, cz = local_shape
    slabs = shell_slabs(local_shape)
    refresh = make_domain_refresh(dspec, axes, local_shape,
                                  spin_in_gather=spin_in_gather,
                                  allgather=allgather)

    def grads(nbh: DomainNbh, spin, sj, types, field):
        """One replica: (E_local, direct force, -dE/dS, the pair
        reactions and neighbor-spin gradients on the ext-flat rows)."""
        k, m_cap = types.shape[3], nbh.idx.shape[-1]
        occ = types >= 0
        ti = torch.where(occ, types, torch.zeros_like(types))
        dr = nbh.dr.detach().requires_grad_(True)
        s = spin.detach().requires_grad_(True)
        sjv = sj.detach().requires_grad_(True)
        with torch.enable_grad():
            drf = dr.reshape(-1, m_cap, 3)
            dist = torch.sqrt(torch.sum(drf * drf, dim=-1) + 1e-30)
            er = potential.pair_energies(
                drf, dist, nbh.mask.reshape(-1, m_cap), ti.reshape(-1),
                nbh.tj.reshape(-1, m_cap), s.reshape(-1, 3),
                sjv.reshape(-1, m_cap, 3))
            e = torch.sum(torch.where(occ.reshape(-1), er,
                                      torch.zeros_like(er)))
            if field is not None:
                mom = _zeeman_moments(potential, ti, occ, s)
                b = torch.as_tensor(field, dtype=s.dtype, device=s.device)
                e = e - units.MU_B * torch.sum(mom[..., None] * s * b)
            g = torch.autograd.grad(e, (dr, s, sjv), allow_unused=True)
        g_dr, g_s, g_sj = (torch.zeros_like(x) if gi is None else gi
                           for gi, x in zip(g, (dr, s, sjv)))
        m = nbh.mask[..., None]
        g_f = torch.where(m, g_dr, torch.zeros_like(g_dr))
        g_n = torch.where(m, g_sj, torch.zeros_like(g_sj))
        payload = torch.cat([g_f, g_n], dim=-1).reshape(-1, 6)
        scat = reverse_sum(payload, nbh.rev).reshape(cx + 2, cy + 2, cz + 2,
                                                     k, 6)
        return e.detach(), torch.sum(g_f, dim=-2), g_s, scat

    def evaluate(nbh: DomainNbh, spin, sj, types, field):
        lead = _lead(types)
        if lead:
            per_rep = field is not None and torch.as_tensor(field).dim() == 2
            per = [grads(replica_nbh(nbh, r), spin[r], sj[r], types[r],
                         field[r] if per_rep else field)
                   for r in range(types.shape[0])]
            e, direct, g_s, scat = (torch.stack(p) for p in zip(*per))
        else:
            e, direct, g_s, scat = grads(nbh, spin, sj, types, field)
        folded = fold_halo_multi({"react": scat[..., :3],
                                  "gspin": scat[..., 3:]}, axes,
                                 tag="adjoint", allgather=allgather,
                                 lead=lead)
        return e, direct - folded["react"], -(g_s + folded["gspin"])

    def compute_fused(nbh: DomainNbh, spin, types, field=None):
        """From the pre-gathered (dr, sj) blocks: no forward message, one
        adjoint fold."""
        return evaluate(nbh, spin, nbh.sj, types, field)

    def compute_exchanging(nbh: DomainNbh, spin, types, field=None):
        """Re-exchanges spin ghosts (midpoint iterations evaluate at
        updated spins): one spin halo and one adjoint fold."""
        lead = _lead(types)
        pending = exchange_halo(spin, axes, dims=cell_dims(lead), tag="spin",
                                allgather=allgather, async_op=True)

        def gather(src, sl):
            return {"sj": _rows(src, nbh.idx[sl].long(), lead)}

        sj = _gather_blocks(pending, nbh.idx, slabs,
                            lambda: local_wrap(spin, dims=cell_dims(lead)),
                            gather, lead)["sj"]
        return evaluate(nbh, spin, sj, types, field)

    return refresh, (compute_fused if spin_in_gather else compute_exchanging)


def make_domain_kernel_evaluator(potential, dspec: DomainSpec, axes,
                                 local_shape, allgather: bool = False):
    """``(refresh, compute)`` of the sharded loop through the hand-written
    NEP kernels K1 and K2 - the paper's distributed algorithm:

    * K1 (``nep_atom_pass``) runs on the rank's cell-major slots.  It has
      no atom mask: an empty slot's type is clamped to 0 for the launch
      and its energy, direct field and adjoints are zeroed after it, the
      reference's exact zeros;
    * the adjoint accumulators Abar travel to the neighbouring ranks in
      ONE halo round (tag ``"qfp"``, the paper's q_Fp communication),
      replacing the autograd path's reaction fold: K2's pair-symmetric
      force needs only a *gather* of neighbour adjoints;
    * K2 (``nep_force_pass``) reads them through the table renumbered into
      the local-first row space, ``abar_rows = cat(abar_local,
      abar_ring)``, and gives complete forces and fields of the owned
      atoms in one neighbour traversal.

    With local replicas (a leading replica axis on every block) one K1 and
    one K2 launch serve all of them, each replica on its own clamped
    ``ti``, its own local-first table ``lf`` and its own ``abar`` rows
    (R, n_src, A); their adjoints share one q_Fp round.

    ``compute`` reads the ``dr`` AND ``sj`` blocks of the drift refresh
    (``nbh.lf``, the local-first table, comes from the rebuild), so
    self-consistent midpoint configs are not supported."""
    from repro_torch.kernels.nep.kernel import nep_atom_pass, nep_force_pass

    spec, params = potential.spec, potential.params
    refresh = make_domain_refresh(dspec, axes, local_shape,
                                  spin_in_gather=True, allgather=allgather)
    cx, cy, cz = local_shape
    _, ring = local_first_index(local_shape, dspec.capacity,
                                params.w1.device)

    def compute(nbh: DomainNbh, spin, types, field=None):
        lead = _lead(types)
        rl = types.shape[:lead]                   # () or (R,)
        k, m_cap = types.shape[-1], nbh.idx.shape[-1]
        n_slots = cx * cy * cz * k
        occ = types.reshape(rl + (-1,)) >= 0
        ti = torch.where(occ, types.reshape(rl + (-1,)),
                         torch.zeros_like(occ, dtype=types.dtype)
                         ).contiguous()
        dr = nbh.dr.reshape(rl + (n_slots, m_cap, 3))
        mask = nbh.mask.reshape(rl + (n_slots, m_cap))
        tj = nbh.tj.reshape(rl + (n_slots, m_cap))
        si = spin.reshape(rl + (n_slots, 3))
        sj = nbh.sj.reshape(rl + (n_slots, m_cap, 3))
        e, hdir, abar = nep_atom_pass(spec, params, dr, mask, ti, tj, si, sj)
        o1, o2 = occ[..., None], occ
        e = torch.where(o2, e, torch.zeros_like(e))
        hdir = torch.where(o1, hdir, torch.zeros_like(hdir))
        abar = torch.where(o1, abar, torch.zeros_like(abar))
        # the q_Fp exchange: every adjoint channel of every local replica
        # in one halo round
        a = abar.shape[-1]
        ext = exchange_halo(abar.reshape(rl + (cx, cy, cz, k, a)), axes,
                            dims=cell_dims(lead), tag="qfp",
                            allgather=allgather)
        rows = torch.cat([abar, ext.reshape(rl + (-1, a))[..., ring, :]],
                         dim=-2)
        f, h2 = nep_force_pass(spec, params, dr, mask, nbh.lf, ti, tj, si,
                               sj, rows)
        force = torch.where(o1, f, torch.zeros_like(f)).reshape(
            types.shape + (3,))
        heff = torch.where(o1, hdir + h2, torch.zeros_like(h2)).reshape(
            types.shape + (3,))
        e_loc = slot_sum(e, lead)
        if field is not None:
            mom = _zeeman_moments(potential, types.clamp(min=0), types >= 0,
                                  spin)
            b = _field_block(field, spin, lead)
            e_loc = e_loc - _zeeman_energy(mom, spin, b, lead)
            heff = heff + units.MU_B * mom[..., None] * b
        return e_loc, force, heff

    return refresh, compute


# ---------------------------------------------------------------------------
# the legacy per-evaluation paths (one evaluation = halo exchange + local
# evaluation + one scalar energy reduction; no carried table state)
# ---------------------------------------------------------------------------
#
# Each function runs on one rank's slab of ``pack_domain``'s global grid:
# ``pos``/``spin`` (cx, cy, cz, K, 3), ``types`` (cx, cy, cz, K) (empty slots
# may hold any type: ``mask`` says which slots hold atoms).  The reference
# differentiates the psum'd energy inside shard_map, whose transpose of
# ppermute folds the ghosts' gradients back for free; here the local energy
# is differentiated through :class:`_HaloExchange` (its backward is
# ``fold_halo``) and only the scalar value is all-reduced, outside the graph.
# Ledger tags: ``legacy-pos``/``-spin``/``-types``/``-ids`` for the forward
# exchanges, ``legacy-adjoint`` for the folds, ``qfp`` for the kernel path's
# adjoint round, ``energy`` for each all_reduce of the energy.

def _legacy_axes(dspec: DomainSpec, mesh):
    """(halo axes, allgather, local cell shape) of this rank: the Sharded
    plan's ``"auto"`` halo mode, allgather when every sharded axis is at
    most 8 wide."""
    from repro_torch.parallel.halo import halo_axes
    from repro_torch.parallel.plan import _mesh_shape
    axes = halo_axes(mesh, dspec.axis_map)
    return (axes, all(ax is None or ax.size <= 8 for ax in axes),
            tuple(dspec.local_shape(_mesh_shape(mesh))))


class _HaloExchange(torch.autograd.Function):
    """``exchange_halo`` whose backward is ``fold_halo``: the gradients on
    ghost copies travel back to their owners (the reverse communication
    the reference gets from shard_map's transpose of ppermute)."""

    @staticmethod
    def forward(ctx, x, axes, tag, allgather):
        ctx.axes, ctx.allgather = axes, allgather
        return exchange_halo(x, axes, tag=tag, allgather=allgather)

    @staticmethod
    def backward(ctx, g):
        return (fold_halo(g.contiguous(), ctx.axes, tag="legacy-adjoint",
                          allgather=ctx.allgather), None, None, None)


def _exchange(x, axes, tag: str, allgather: bool):
    if x.is_floating_point():
        return _HaloExchange.apply(x, axes, tag, allgather)
    return exchange_halo(x, axes, tag=tag, allgather=allgather)


def _rank_index(axes) -> int:
    """This rank's linear index over the sharded axes (the reference's
    axis_index over the axis map)."""
    dev = 0
    for ax in axes:
        if ax is not None:
            dev = dev * ax.size + ax.index
    return dev


def reduce_energy(e: torch.Tensor, axes) -> torch.Tensor:
    """The rank-local energy summed over every sharded axis (one
    ``all_reduce`` per axis, as the reference's psum per axis name),
    outside the graph; recorded in the ledger under ``"energy"``."""
    e = e.detach().clone()
    for ax in axes:
        if ax is not None and ax.size > 1:
            import torch.distributed as dist
            from repro_torch.parallel.halo import record
            record("energy", e.numel() * e.element_size())
            dist.all_reduce(e, group=ax.group)
    return e


def _eps(dtype) -> float:
    return 1e-12 if dtype == torch.float32 else 1e-30


def _site_energy(spec, params, q, ti, mask, spin, field, moments):
    """Masked MLP energy of the descriptors plus the Zeeman term."""
    from repro_torch.core.potential import mlp_energy
    e = mlp_energy(params, q.reshape(-1, spec.n_desc), ti.reshape(-1))
    etot = torch.sum(torch.where(mask.reshape(-1), e, torch.zeros_like(e)))
    if field is not None:
        mom = moments.to(dtype=spin.dtype, device=spin.device)[ti.long()]
        mom = torch.where(mask, mom, torch.zeros_like(mom))
        b = torch.as_tensor(field, dtype=spin.dtype, device=spin.device)
        etot = etot - units.MU_B * torch.sum(mom[..., None] * spin * b)
    return etot


def _local_energy(spec, dspec: DomainSpec, axes, params, pos, spin, types,
                  mask, field, moments, allgather: bool = False):
    """Rank-local energy: halo exchange + 27-shift streaming accumulation
    (one own-cell x neighbour-cell (K x K) pair block per shift).

    Under autograd each shift's pair block is recomputed in the backward
    pass (``torch.utils.checkpoint`` per shift, the reference's
    ``jax.checkpoint`` over its scan body), so the 27 blocks are never all
    live at once."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.core.descriptor import accumulate, finalize, \
        init_accumulators
    dtype, dev = pos.dtype, pos.device
    box = torch.as_tensor(dspec.box, dtype=dtype, device=dev)
    cx, cy, cz, k = mask.shape
    n_loc = cx * cy * cz * k
    # globally unique slot ids (0 = empty) for the self-pair exclusion
    ids = (torch.arange(n_loc, dtype=torch.int32, device=dev).reshape(
        mask.shape) + _rank_index(axes) * n_loc + 1)
    ids = torch.where(mask, ids, torch.zeros_like(ids))
    ext_pos = _exchange(pos, axes, "legacy-pos", allgather)
    ext_spin = _exchange(spin, axes, "legacy-spin", allgather)
    ext_type = _exchange(types, axes, "legacy-types", allgather)
    ext_ids = _exchange(ids, axes, "legacy-ids", allgather)
    ti = torch.where(mask, types, torch.zeros_like(types))
    eps = _eps(dtype)
    dp = params.desc_params()

    def shift(acc, ext_pos, ext_spin, pos, spin, sx, sy, sz):
        cut = (slice(sx, sx + cx), slice(sy, sy + cy), slice(sz, sz + cz))
        npos, nspin = ext_pos[cut], ext_spin[cut]
        ntype, nids = ext_type[cut], ext_ids[cut]
        dr = _min_image(npos[..., None, :, :] - pos[..., :, None, :], box)
        dist = torch.sqrt(torch.sum(dr * dr, dim=-1) + eps)
        pmask = (mask[..., :, None] & (nids[..., None, :] > 0)
                 & (ids[..., :, None] != nids[..., None, :])
                 & (dist <= dspec.cutoff))
        tj = torch.where(nids > 0, ntype, torch.zeros_like(ntype))
        return accumulate(spec, dp, acc, dr, dist, pmask, ti,
                          tj[..., None, :].expand(cx, cy, cz, k, k), spin,
                          nspin[..., None, :, :].expand(cx, cy, cz, k, k, 3))

    acc = init_accumulators(spec, (cx, cy, cz, k), dtype, dev)
    for dx, dy, dz in _SHIFTS:
        args = (acc, ext_pos, ext_spin, pos, spin, 1 + dx, 1 + dy, 1 + dz)
        if torch.is_grad_enabled():
            acc = checkpoint(shift, *args, use_reentrant=False)
        else:
            acc = shift(*args)
    q = finalize(spec, acc, spin)
    return _site_energy(spec, params, q, ti, mask, spin, field, moments)


def _moments(spec, moments):
    if moments is not None:
        return torch.as_tensor(moments)
    return torch.ones(max(spec.n_types, 1))


def _grad_evaluator(local_energy, axes):
    """``(E, F, H_eff)`` of a rank-local energy function of (pos, spin):
    E summed over the ranks, F and H_eff the negative gradients of the
    local energy, ghosts folded back."""
    def evaluate(pos, spin, *rest):
        p = pos.detach().requires_grad_(True)
        s = spin.detach().requires_grad_(True)
        with torch.enable_grad():
            e = local_energy(p, s, *rest)
            gp, gs = torch.autograd.grad(e, (p, s))
        return reduce_energy(e, axes), -gp, -gs
    return evaluate


def distributed_energy_fn(spec, dspec: DomainSpec, mesh, field=None,
                          moments=None):
    """``(energy_fn, energy_forces_field_fn)`` of the 27-stencil path on
    this rank of ``mesh`` (a ``DeviceMesh`` whose dimensions ``dspec.
    axis_map`` names; None: one rank, no process group).

    ``energy(params, state) -> E`` and ``energy_forces_field(params, state)
    -> (E, F, H_eff)`` take this rank's :class:`DomainState` slab; E is
    the global energy (one scalar all_reduce per sharded axis), F and
    H_eff this rank's blocks.  ``energy_forces_field.raw(params, pos,
    spin, types, mask)`` takes the blocks.  Halos go in the Sharded plan's
    ``"auto"`` mode."""
    axes, ag, _ = _legacy_axes(dspec, mesh)
    mom = _moments(spec, moments)

    def local(params, pos, spin, types, mask):
        return _local_energy(spec, dspec, axes, params, pos, spin, types,
                             mask, field, mom, ag)

    def energy(params, state: DomainState):
        with torch.no_grad():
            return reduce_energy(local(params, state.pos, state.spin,
                                       state.types, state.mask), axes)

    def raw(params, pos, spin, types, mask):
        return _grad_evaluator(
            lambda p, s: local(params, p, s, types, mask), axes)(pos, spin)

    def energy_forces_field(params, state: DomainState):
        return raw(params, state.pos, state.spin, state.types, state.mask)

    energy_forces_field.raw = raw
    return energy, energy_forces_field


# ---------------------------------------------------------------------------
# the pre-staged (pruned) table: the paper's Phase-A/B pre-staging
# ---------------------------------------------------------------------------
#
# The 27-cell stencil enumerates 27*K candidates per atom, of which ~40-55
# fall inside the cutoff.  A pruned per-atom table (the M nearest, into the
# halo-extended slots) built once per skin violation lets an evaluation
# stream exactly M candidates.

def build_domain_table(spec, dspec: DomainSpec, axes, capacity: int, pos,
                       types, mask, allgather: bool = False):
    """This rank's pruned table ``(idx (cx,cy,cz,K,M) int32 into the
    ext-flat slots, nbr_mask (cx,cy,cz,K,M) bool)``, M = min(capacity,
    27K): :func:`build_local_table` with ``mask`` as the occupancy (at the
    legacy paths' skin 0 the reference's table; its invalid entries point
    at the atom's own slot instead of 0)."""
    typ = torch.where(mask, types, torch.full_like(types, -1))
    idx, nmask, _ = build_local_table(dspec, axes, tuple(mask.shape[:3]),
                                      capacity, pos, typ,
                                      allgather=allgather)
    return idx, nmask


def _local_energy_pruned(spec, dspec: DomainSpec, axes, params, pos, spin,
                         types, mask, tbl_idx, tbl_mask, field, moments,
                         allgather: bool = False):
    """Rank-local energy through the pruned table: ONE accumulate pass
    over M candidates instead of 27 stencil blocks."""
    from repro_torch.core.descriptor import accumulate, finalize, \
        init_accumulators
    dtype = pos.dtype
    box = torch.as_tensor(dspec.box, dtype=dtype, device=pos.device)
    exf_pos = _exchange(pos, axes, "legacy-pos", allgather).reshape(-1, 3)
    exf_spin = _exchange(spin, axes, "legacy-spin", allgather).reshape(-1, 3)
    exf_type = _exchange(torch.clamp(types, min=0), axes, "legacy-types",
                         allgather).reshape(-1)
    idx = tbl_idx.long()
    dr = _min_image(exf_pos[idx] - pos[..., None, :], box)
    dist = torch.sqrt(torch.sum(dr * dr, dim=-1) + _eps(dtype))
    pmask = tbl_mask & (dist <= dspec.cutoff)
    ti = torch.where(mask, types, torch.zeros_like(types))
    acc = init_accumulators(spec, tuple(mask.shape), dtype, pos.device)
    acc = accumulate(spec, params.desc_params(), acc, dr, dist, pmask, ti,
                     exf_type[idx], spin, exf_spin[idx])
    q = finalize(spec, acc, spin)
    return _site_energy(spec, params, q, ti, mask, spin, field, moments)


def distributed_energy_fn_pruned(spec, dspec: DomainSpec, mesh,
                                 capacity: int = 64, field=None,
                                 moments=None):
    """Pre-staged variant: ``(build_table, energy_forces_field)``.

    ``build_table(pos, types, mask) -> (idx, nbr_mask)`` on this rank
    (rebuilt on skin violations, as the flat path's table);
    ``energy_forces_field(params, pos, spin, types, mask, idx, nbr_mask)
    -> (E, F, H_eff)`` as :func:`distributed_energy_fn`'s."""
    axes, ag, _ = _legacy_axes(dspec, mesh)
    mom = _moments(spec, moments)

    def build(pos, types, mask):
        return build_domain_table(spec, dspec, axes, capacity, pos, types,
                                  mask, allgather=ag)

    def energy_forces_field(params, pos, spin, types, mask, tbl_idx,
                            tbl_mask):
        return _grad_evaluator(
            lambda p, s: _local_energy_pruned(
                spec, dspec, axes, params, p, s, types, mask, tbl_idx,
                tbl_mask, field, mom, ag), axes)(pos, spin)

    return build, energy_forces_field


# ---------------------------------------------------------------------------
# the kernel path: K1 -> one q_Fp halo round -> K2, per evaluation
# ---------------------------------------------------------------------------

def distributed_kernel_force_fn(spec, dspec: DomainSpec, mesh,
                                capacity: int = 64, field=None, moments=None):
    """``(build_table, energy_forces_field)`` with the signatures of
    :func:`distributed_energy_fn_pruned`, evaluated by the hand-written
    kernels instead of autograd: K1 on the rank's slots, the adjoints
    ``abar`` to the neighbouring ranks in one halo round (tag ``"qfp"``),
    K2 reading them through the table renumbered local-first.  It is the
    sharded loop's evaluator (:func:`make_domain_kernel_evaluator`, with
    :func:`local_first_index`) driven per evaluation: one fused (pos, spin)
    exchange gathers ``dr`` and the neighbour spins, one ``types`` exchange
    gives the neighbour types.  On CUDA tensors K1 and K2 launch (or
    raise); on CPU tensors their plain versions run.  The kernels take any
    number of slots (no tile padding)."""
    from repro_torch.core.potential import NEPSpinPotential
    axes, ag, local = _legacy_axes(dspec, mesh)
    mom = _moments(spec, moments)
    refresh = make_domain_refresh(dspec, axes, local, allgather=ag)
    ext_to_lf = {}

    def build(pos, types, mask):
        return build_domain_table(spec, dspec, axes, capacity, pos, types,
                                  mask, allgather=ag)

    def blocks(pos, spin, types, mask, tbl_idx, tbl_mask):
        """What one evaluation hands K1/K2: ``(DomainNbh with dr, sj, tj
        and the local-first table lf, types with -1 on empty slots)``."""
        dev = pos.device
        if dev not in ext_to_lf:
            ext_to_lf[dev] = local_first_index(local, dspec.capacity, dev)[0]
        ext_t = exchange_halo(torch.clamp(types, min=0), axes,
                              tag="legacy-types", allgather=ag)
        idx = tbl_idx.long()
        tj = torch.where(tbl_mask, ext_t.reshape(-1)[idx],
                         torch.zeros_like(idx)).to(torch.int32)
        lf = ext_to_lf[dev][idx.reshape(-1, idx.shape[-1])].to(torch.int32)
        nbh = refresh(pos, DomainNbh(idx=tbl_idx, mask=tbl_mask, tj=tj,
                                     dr=None, lf=lf), spin, tag="legacy-pos")
        return nbh, torch.where(mask, types, torch.full_like(types, -1))

    def energy_forces_field(params, pos, spin, types, mask, tbl_idx,
                            tbl_mask):
        potential = NEPSpinPotential(spec, params, mom.to(
            dtype=pos.dtype, device=pos.device), use_kernel=True)
        _, compute = make_domain_kernel_evaluator(potential, dspec, axes,
                                                  local, allgather=ag)
        nbh, typ = blocks(pos, spin, types, mask, tbl_idx, tbl_mask)
        e, force, heff = compute(nbh, spin, typ, field)
        return reduce_energy(e, axes), force, heff

    energy_forces_field.blocks = blocks
    return build, energy_forces_field
