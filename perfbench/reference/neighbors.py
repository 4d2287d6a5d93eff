"""Neighbor search of the reference: every ordered pair (i, j), i != j,
closer than the cutoff under the minimum image, found through linked cells
of width >= the cutoff (all pairs when the box holds fewer than three
cells a side), in blocks of atoms."""
from __future__ import annotations

import torch

BLOCK = 16384


def min_image(dr: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    return dr - box * torch.round(dr / box)


def _cells(pos, box, rc):
    n_cells = torch.clamp(torch.floor(box / rc), min=1).to(torch.int64)
    c = torch.minimum((pos / box * n_cells).to(torch.int64), n_cells - 1)
    c = torch.clamp(c, min=0)
    return c, [int(x) for x in n_cells]


def neighbor_list(pos: torch.Tensor, box: torch.Tensor, rc: float,
                  block: int = BLOCK):
    """``(idx (N, M) int64, mask (N, M) bool)``: row i lists the atoms
    closer than ``rc`` to atom i (padded with i itself, mask False), M the
    largest count."""
    n = pos.shape[0]
    dev = pos.device
    c, (cx, cy, cz) = _cells(pos, box, rc)
    if min(cx, cy, cz) < 3:
        cand_of = lambda rows: torch.arange(n, device=dev).expand(
            rows.numel(), n)
    else:
        flat = (c[:, 0] * cy + c[:, 1]) * cz + c[:, 2]
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=cx * cy * cz)
        start = torch.cumsum(counts, 0) - counts
        kc = int(counts.max())
        slot = torch.arange(n, device=dev) - start[flat[order]]
        grid = torch.full((cx * cy * cz, kc), -1, dtype=torch.int64,
                          device=dev)
        grid[flat[order], slot] = order
        offs = torch.tensor([(a, b, d) for a in (-1, 0, 1)
                             for b in (-1, 0, 1) for d in (-1, 0, 1)],
                            device=dev)
        dims = torch.tensor([cx, cy, cz], device=dev)

        def cand_of(rows):
            cc = (c[rows][:, None, :] + offs[None]) % dims
            cell = (cc[..., 0] * cy + cc[..., 1]) * cz + cc[..., 2]
            return grid[cell].reshape(rows.numel(), -1)

    rows_all, m_max = [], 1
    for lo in range(0, n, block):
        rows = torch.arange(lo, min(lo + block, n), device=dev)
        cand = cand_of(rows)
        ok = cand >= 0
        safe = torch.where(ok, cand, rows[:, None])
        dr = min_image(pos[safe] - pos[rows][:, None, :], box)
        keep = ok & (torch.sum(dr * dr, dim=-1) < rc * rc) & (
            safe != rows[:, None])
        first = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        cnt = int(keep.sum(1).max()) if keep.numel() else 0
        m_max = max(m_max, cnt)
        rows_all.append((torch.gather(safe, 1, first),
                         torch.gather(keep, 1, first)))
    idx = torch.empty((n, m_max), dtype=torch.int64, device=dev)
    mask = torch.zeros((n, m_max), dtype=torch.bool, device=dev)
    lo = 0
    for s, k in rows_all:
        b = s.shape[0]
        w = min(m_max, s.shape[1])
        kk = k[:, :w]
        rows = torch.arange(lo, lo + b, device=dev)[:, None]
        idx[lo:lo + b] = rows
        idx[lo:lo + b, :w] = torch.where(kk, s[:, :w], rows)
        mask[lo:lo + b, :w] = kk
        lo += b
    return idx, mask


def missing_pairs(pos, box, rc, table_idx, table_mask) -> int:
    """Pairs closer than ``rc`` that a table (``idx`` (N, M'), ``mask``)
    does not list: what a neighbor table built earlier, with a skin, must
    still hold."""
    idx, mask = neighbor_list(pos, box, rc)
    n = pos.shape[0]
    rows = torch.arange(n, device=pos.device)[:, None]
    want = (rows * n + idx)[mask]
    have = (rows * n + table_idx.to(pos.device).long())[
        table_mask.to(pos.device)]
    return int((~torch.isin(want, have)).sum())
