"""Parallel plans: the execution-layout axis of the MD engine (port of
``repro.parallel.plan``).

  :class:`SingleDevice`   flat (N, ...) tensors on one device, optionally in
                          cell-ordered rows.
  :class:`Replicated`     a leading replica axis over the same loop: one
                          shared neighbor table, per-replica ``dr`` /
                          forces / generators, K1 and K2 launched once for
                          all replicas; ``devices`` (a ``DeviceMesh`` or
                          ranks) splits the replica axis over the ranks,
                          each holding R / ranks replicas.
  :class:`Sharded`        spatial domain decomposition over the cell-major
                          ``(CX, CY, CZ, K)`` layout on ``torch.distributed``:
                          one process per mesh position holds its slab of
                          cells on its own device; halo exchange, cell
                          migration at rebuilds, all-reduced scalars
                          (:mod:`repro_torch.parallel.domain`).
                          ``replicas > 0`` composes a leading replica axis
                          with the spatial mesh (the replicas x domain
                          plan): every replica is a full decomposition of
                          the crystal with its own cells and table.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dimensions (the counterpart of the reference's JAX ``Mesh``): ``mesh=None``
means a 1-D ``"sx"`` mesh over the initialised world - or over the ranks
``devices`` names, for an elastic restart onto fewer ranks - or, with no
process group or a single rank in ``devices``, a one-rank plan that issues
no collectives.  A 2-D mesh may
carry a ``"replica"`` dimension (``replica_axis``): replicas are split over
it, while halos and spatial reductions run over the spatial dimensions
only.  :meth:`Sharded.resolve` performs the reference's slot-minimizing
global cell-grid search with the skin-robust occupancy bound (every atom
within ``skin`` of a cell counts toward it, so boundary churn between
rebuilds cannot overflow the chosen capacity).  Building a mesh, or a group
over a mesh smaller than the world, is a collective: every rank of the
world resolves the plan, and a rank outside the mesh then raises (for one
rank in ``devices`` nothing is built, and only the other ranks raise).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Flat single-device plan."""

    cell_order: bool | None = None   # linked-cell row sort; None -> iff cell list

    replicas: int = 0                # uniform plan API


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Replica plan: an (R, N, ...) batch through one loop on one card."""

    replicas: int
    devices: Any = None              # DeviceMesh or ranks: split the
                                     # replica axis over them

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("Replicated plan needs replicas >= 1")


def _mesh_shape(mesh) -> dict:
    """{dimension name: size} of a DeviceMesh (empty for no mesh)."""
    if mesh is None:
        return {}
    return {name: int(size) for name, size in
            zip(mesh.mesh_dim_names, mesh.mesh.shape)}


@dataclasses.dataclass(frozen=True)
class Sharded:
    """Domain-decomposition plan over a ``DeviceMesh``.

    ``mesh`` / ``axis_map`` / ``cells`` / ``cell_capacity`` left at their
    defaults are resolved against the state geometry by :meth:`resolve`,
    which returns a fully wired :class:`ResolvedSharded`.
    """

    mesh: Any = None                   # DeviceMesh (None -> 1-D "sx")
    axis_map: tuple | None = None      # spatial dim -> mesh dimension name
    halo_mode: str = "auto"            # "ppermute" | "allgather" | "auto"
    cells: tuple | None = None         # global cell grid (None -> auto)
    cell_capacity: int | None = None   # per-cell capacity K (None -> auto)
    replicas: int = 0                  # 0 = no replica axis
    replica_axis: str = "replica"
    devices: tuple | None = None       # ranks of the default group for the
                                       # auto 1-D mesh (an elastic restart
                                       # onto fewer ranks)

    def __post_init__(self):
        if self.replicas < 0:
            raise ValueError("Sharded plan needs replicas >= 0")
        if self.devices is not None:
            object.__setattr__(self, "devices",
                               tuple(int(r) for r in self.devices))
            if not self.devices:
                raise ValueError("Sharded(devices=()) names no rank")
        if self.halo_mode not in ("auto", "ppermute", "allgather"):
            raise ValueError(f"unknown halo_mode {self.halo_mode!r}")

    # ------------------------------------------------------------------
    def resolve(self, box, pos, cutoff: float, skin: float,
                dtype_is_f32: bool) -> "ResolvedSharded":
        """Fix mesh, axis map, cell grid and capacity for a geometry (every
        rank calls it with the same global ``pos``)."""
        import torch.distributed as dist

        from repro_torch.md.neighbor import grid_shape
        from repro_torch.parallel.domain import DomainSpec
        from repro_torch.parallel.halo import halo_axes

        mesh, axis_map = self.mesh, self.axis_map
        grouped = dist.is_available() and dist.is_initialized()
        if mesh is None and grouped and self.devices is not None \
                and len(self.devices) == 1:
            # one rank: the one-rank plan, no mesh and no collective
            if dist.get_rank() != self.devices[0]:
                raise ValueError(
                    f"rank {dist.get_rank()} is not in the Sharded plan's "
                    f"mesh (ranks {list(self.devices)}); run the Engine on "
                    "those ranks only")
        elif mesh is None and grouped:
            mesh = _auto_mesh(self.devices)
        elif mesh is None and self.devices not in (None, (0,)):
            raise ValueError(f"Sharded(devices={self.devices}) needs an "
                             "initialised process group")
        shape = _mesh_shape(mesh) or {"sx": 1}
        if axis_map is None:
            names = tuple(n for n in shape if n != self.replica_axis)
            axis_map = tuple(list(names[:3]) + [None] * (3 - len(names)))
        axis_map = tuple(axis_map)
        if self.replica_axis in axis_map:
            raise ValueError(f"the replica dimension {self.replica_axis!r} "
                             "cannot shard a spatial dim")
        if (self.replicas and self.replica_axis in shape
                and self.replicas % shape[self.replica_axis]):
            raise ValueError(
                f"{self.replicas} replicas not divisible by mesh axis "
                f"{self.replica_axis}={shape[self.replica_axis]}")
        groups = _MeshGroups.of(mesh, axis_map, self.replica_axis)

        box = np.asarray(box.cpu() if isinstance(box, torch.Tensor)
                         else box, np.float64)
        pos_np = np.asarray(pos.detach().cpu() if isinstance(pos, torch.Tensor)
                            else pos)
        n = pos_np.shape[0]

        corner_bins = {}

        def bins(d, c):
            """Per atom the cell index along dim ``d`` of the grid's ``c``
            cells at -skin and +skin, and whether the two differ."""
            if (d, c) not in corner_bins:
                lo, hi = (np.floor((pos_np[:, d].astype(np.float64) + s)
                                   / box[d] * c)
                          .astype(np.int64) % c for s in (-skin, skin))
                corner_bins[d, c] = (lo, hi, lo != hi)
            return corner_bins[d, c]

        def occ_bound_of(cells):
            """Skin-robust per-cell occupancy bound: every atom within
            ``skin`` of a cell counts toward it (once per distinct cell its
            8 corners at +-skin fall in).  Atoms move less than skin/2
            between rebuilds, so a capacity at this bound cannot overflow
            from boundary churn - and grids whose edges align with crystal
            planes price that risk in."""
            per = [bins(d, int(c)) for d, c in enumerate(cells)]
            counts = np.zeros(int(np.prod(cells)), np.int64)
            for a in (0, 1):
                for b in (0, 1):
                    for c in (0, 1):
                        keep = np.ones(n, bool)
                        for (lo, hi, two), pick in zip(per, (a, b, c)):
                            if pick:
                                keep &= two
                        ix, iy, iz = (p[1] if pick else p[0] for p, pick in
                                      zip(per, (a, b, c)))
                        flat = (ix * cells[1] + iy) * cells[2] + iz
                        counts += np.bincount(flat[keep],
                                              minlength=counts.size)
            return int(counts.max())

        if self.cells is not None:
            cells = tuple(self.cells)
        else:
            # global cell grid: cells >= cutoff+skin wide, sharded dims
            # divisible by their mesh dimension, every dim >= 3; among the
            # legal grids the one with the fewest padded slots
            # (n_cells * capacity)
            base = grid_shape(box, cutoff, skin)
            rc = cutoff + skin
            axes_n = [shape[name] if name is not None else 1
                      for name in axis_map]
            cand_per_dim = []
            for d, nd in enumerate(axes_n):
                # >= 3 global cells and >= 2 per rank; cells no wider than
                # ~2.5x the reach
                lo = max(3, 2 * nd, int(np.ceil(box[d] / (2.5 * rc))))
                vals = [c for c in range(base[d], lo - 1, -1)
                        if c % nd == 0][:5]
                if not vals and nd > 1:    # fall back to 1 cell per rank
                    vals = [c for c in range(base[d], nd - 1, -1)
                            if c % nd == 0][:5]
                if not vals:
                    raise ValueError(
                        f"box dim {d} ({box[d]:.1f} A) too small for "
                        f"{nd}-way sharding at cutoff+skin {rc:.2f} A")
                cand_per_dim.append(vals)
            best, best_slots = None, None
            for cx in cand_per_dim[0]:
                for cy in cand_per_dim[1]:
                    for cz in cand_per_dim[2]:
                        occ = occ_bound_of((cx, cy, cz))
                        slots = cx * cy * cz * (occ + 2)
                        if best_slots is None or slots < best_slots:
                            best, best_slots = (cx, cy, cz), slots
            cells = best
        k = (self.cell_capacity if self.cell_capacity is not None
             else occ_bound_of(cells) + 2)
        dspec = DomainSpec(cells=tuple(cells), capacity=k, cutoff=cutoff,
                           box=tuple(float(b) for b in box),
                           axis_map=axis_map, skin=skin)
        dspec.check_loop(shape)
        if dtype_is_f32 and max(n, int(np.prod(cells)) * k) >= 1 << 24:
            raise ValueError("f32 cannot carry atom ids this large exactly "
                             "through the fused migration exchange; run in "
                             "f64 or shrink the system")
        spatial = tuple(a for a in axis_map if a is not None)
        if self.halo_mode == "auto":
            allgather = all(shape[a] <= 8 for a in spatial)
        else:
            allgather = self.halo_mode == "allgather"
        local = dspec.local_shape(shape)
        axes = halo_axes(mesh, axis_map)
        offsets = tuple(0 if ax is None else ax.index * c
                        for ax, c in zip(axes, local))
        return ResolvedSharded(plan=self, mesh=mesh, axis_map=axis_map,
                               dspec=dspec, local_shape=local,
                               allgather=allgather, axes=axes,
                               offsets=offsets, groups=groups)


def _auto_mesh(devices):
    """The 1-D ``"sx"`` mesh over the world, or over the ranks ``devices``
    (every rank of the world calls it: making a mesh is a collective)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    world = dist.get_world_size()
    if devices is None:
        return init_device_mesh(kind, (world,), mesh_dim_names=("sx",))
    bad = [r for r in devices if not 0 <= r < world]
    if bad or len(set(devices)) != len(devices):
        raise ValueError(f"Sharded(devices={devices}): ranks must be "
                         f"distinct ranks of the {world}-rank world")
    return DeviceMesh(kind, torch.tensor(devices), mesh_dim_names=("sx",))


@dataclasses.dataclass(frozen=True)
class _MeshGroups:
    """The process groups a rank of a Sharded plan reduces over.

    ``ranks``: the mesh's global ranks in linear (row-major) order, so a
    rank's linear index folds every mesh dimension, the replica one
    included (the reference's ``dev_index``).  ``mesh``: the group of the
    whole mesh (None: the default group, when the mesh is the world).
    ``spatial``: the groups of the spatial dimensions, reduced in turn
    (None: the whole mesh, when it has no replica dimension).
    ``replica``: the replica dimension's group (None without one)."""

    ranks: tuple
    mesh: Any = None
    spatial: tuple | None = None
    replica: Any = None

    @staticmethod
    def of(mesh, axis_map, replica_axis) -> "_MeshGroups":
        if mesh is None:
            return _MeshGroups(ranks=(0,))
        import torch.distributed as dist
        ranks = tuple(int(r) for r in mesh.mesh.reshape(-1).tolist())
        whole = None
        if len(ranks) != dist.get_world_size():
            # a group over part of the world: every rank takes part
            whole = dist.new_group(ranks=sorted(ranks))
        if dist.get_rank() not in ranks:
            raise ValueError(
                f"rank {dist.get_rank()} is not in the Sharded plan's mesh "
                f"(ranks {list(ranks)}); run the Engine on those ranks only")
        names = mesh.mesh_dim_names
        spatial = replica = None
        if replica_axis in names:
            spatial = tuple(mesh.get_group(a) for a in axis_map
                            if a is not None)
            replica = mesh.get_group(replica_axis)
        return _MeshGroups(ranks=ranks, mesh=whole, spatial=spatial,
                           replica=replica)


@dataclasses.dataclass(frozen=True)
class ResolvedSharded:
    """A :class:`Sharded` plan pinned to a concrete geometry and mesh, as
    one rank sees it."""

    plan: Sharded
    mesh: Any                  # DeviceMesh, or None (one rank)
    axis_map: tuple
    dspec: Any                 # repro_torch.parallel.domain.DomainSpec
    local_shape: tuple
    allgather: bool
    axes: tuple                # per spatial dim: HaloAxis or None
    offsets: tuple             # this rank's first global cell per dim
    groups: _MeshGroups = _MeshGroups(ranks=(0,))

    @property
    def world(self) -> int:
        """Ranks in the mesh (1 for a one-rank plan)."""
        return 1 if self.mesh is None else int(self.mesh.mesh.numel())

    @property
    def rank(self) -> int:
        """This process's linear index in the mesh, every dimension folded
        (its rank, for a mesh over the whole world; 0 without one)."""
        if self.world == 1:
            return 0
        import torch.distributed as dist
        return self.groups.ranks.index(dist.get_rank())

    @property
    def replicas(self) -> int:
        return self.plan.replicas

    @property
    def replica_axis(self) -> str:
        return self.plan.replica_axis

    @property
    def spatial_axes(self) -> tuple:
        """The mesh dimensions that shard a spatial dim."""
        return tuple(a for a in self.axis_map if a is not None)

    def rep_in_mesh(self) -> bool:
        """Are the replicas split over a replica dimension of the mesh?"""
        return (self.replicas > 0 and self.mesh is not None
                and self.replica_axis in self.mesh.mesh_dim_names)

    def local_replicas(self) -> int:
        """Replicas this rank holds (0 without a replica axis)."""
        if not self.rep_in_mesh():
            return self.replicas
        return self.replicas // _mesh_shape(self.mesh)[self.replica_axis]

    def replica_offset(self) -> int:
        """The global index of this rank's first replica."""
        if not self.rep_in_mesh():
            return 0
        return self.mesh.get_local_rank(self.replica_axis) \
            * self.local_replicas()

    def replica_offset_of(self, index: int) -> int:
        """:meth:`replica_offset` of the rank at linear mesh ``index``."""
        if not self.rep_in_mesh():
            return 0
        shape = tuple(int(s) for s in self.mesh.mesh.shape)
        dim = list(self.mesh.mesh_dim_names).index(self.replica_axis)
        return int(np.unravel_index(index, shape)[dim]) \
            * self.local_replicas()

    def describe(self) -> dict:
        """JSON-able layout summary (runlog headers, checkpoint
        manifests)."""
        return {"mesh": _mesh_shape(self.mesh) or {"sx": 1},
                "devices": self.world, "cells": list(self.dspec.cells),
                "cell_capacity": int(self.dspec.capacity)}


def replica_ranks(devices) -> tuple | None:
    """The ranks a ``Replicated(devices=...)`` plan splits its replicas
    over: a ``DeviceMesh``'s ranks, a sequence of ranks, or None (one
    process)."""
    if devices is None:
        return None
    if hasattr(devices, "mesh"):             # DeviceMesh
        return tuple(int(r) for r in devices.mesh.reshape(-1).tolist())
    ranks = tuple(devices)
    if not all(isinstance(r, (int, np.integer)) for r in ranks):
        raise ValueError(f"Replicated(devices={devices!r}): a DeviceMesh or "
                         "ranks of the default group")
    return tuple(int(r) for r in ranks)


def as_plan(plan, replicas: int = 0):
    """Normalize ``plan`` (None | str | plan object) to a plan object."""
    if plan is None:
        plan = "replica" if replicas else "single"
    if isinstance(plan, str):
        if plan in ("single", "single_device", "flat"):
            return SingleDevice()
        if plan in ("replica", "replicated"):
            return Replicated(replicas=max(replicas, 1))
        if plan in ("domain", "sharded", "shard_map"):
            return Sharded(replicas=replicas)
        raise ValueError(f"unknown plan {plan!r}")
    if isinstance(plan, (SingleDevice, Replicated, Sharded)):
        return plan
    raise TypeError(f"not a plan: {plan!r}")
