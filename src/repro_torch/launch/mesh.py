"""Production mesh builders (port of ``repro.launch.mesh``).

Meshes are ``torch.distributed`` ``DeviceMesh``es over the initialised
world: a real one (NCCL or gloo ranks) or a fake one
(``init_process_group("fake", ...)``, which the dry run uses to stand for
512 cards on one host).  They are made by FUNCTIONS, never at import, and
building one is a collective of the whole world: every rank calls it.
"""
from __future__ import annotations

import math

from repro_torch.parallel.plan import _mesh_shape as mesh_shape


def _mesh(shape, axes):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the world has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> dict:
    """{dimension name: size} of the production mesh: 16x16 = 256 cards
    ("data", "model"); 2x16x16 = 512 with ``multi_pod`` ("pod", "data",
    "model")."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def make_production_mesh(*, multi_pod: bool = False):
    """The :func:`production_shape` mesh over the world's first ranks."""
    shape = production_shape(multi_pod)
    return _mesh(tuple(shape.values()), tuple(shape))


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")):
    """A small mesh over the first ranks of the world (tests)."""
    return _mesh(tuple(shape), axes)


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in dp_axes(mesh))


def tp_size(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)


def batch_shardings(mesh, batch: dict) -> dict:
    """The DTensor placements of each batch leaf: the leading dimension
    split over the data-parallel dimensions when it divides them, the
    rest replicated (the reference's ``_batch_shardings``)."""
    from repro_torch.parallel.sharding import placements
    dp = dp_axes(mesh)
    n = dp_size(mesh)
    spec = (dp if len(dp) > 1 else dp[0]) if dp else None
    return {k: placements(mesh, ((spec if v.shape[0] % n == 0 else None),))
            for k, v in batch.items()}
