"""Compute/communication overlap (port of ``repro.parallel.overlap``).

:func:`shell_slabs` splits a local cell grid into its **interior** block
(cells whose whole 27-stencil is local) and a **boundary shell** of six face
slabs.  The domain layer issues a halo exchange asynchronously
(:func:`repro_torch.parallel.halo.exchange_halo` with ``async_op=True``),
gathers the interior slab from the :func:`~repro_torch.parallel.halo.
local_wrap` image (no message needed: interior cells never read a ghost),
then waits for the exchange and gathers the shell - the classical MD trick
of computing the interior while the face ghosts are in flight.  This is the
torch form of the reference's ``issue_early`` scheduling barrier.
"""
from __future__ import annotations


def shell_slabs(shape: tuple[int, int, int]
                ) -> list[tuple[tuple[slice, slice, slice], bool]]:
    """Interior/boundary slab decomposition of a (cx, cy, cz) grid.

    Returns ``[(slices, is_interior), ...]``; the slices partition the grid
    (no cell twice): the interior block first, then up to six boundary slabs
    (x faces full, y faces minus x faces, z faces minus both).  When any dim
    is < 3 there is no interior and the whole grid is one boundary slab.
    """
    cx, cy, cz = shape
    if min(cx, cy, cz) < 3:
        return [((slice(0, cx), slice(0, cy), slice(0, cz)), False)]
    inner_x, inner_y = slice(1, cx - 1), slice(1, cy - 1)
    return [
        ((inner_x, inner_y, slice(1, cz - 1)), True),          # interior
        ((slice(0, 1), slice(0, cy), slice(0, cz)), False),    # x faces
        ((slice(cx - 1, cx), slice(0, cy), slice(0, cz)), False),
        ((inner_x, slice(0, 1), slice(0, cz)), False),         # y faces
        ((inner_x, slice(cy - 1, cy), slice(0, cz)), False),
        ((inner_x, inner_y, slice(0, 1)), False),              # z faces
        ((inner_x, inner_y, slice(cz - 1, cz)), False),
    ]

