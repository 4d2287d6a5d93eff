"""Start ranks for the Sharded plan: one process per mesh position.

:func:`spawn` runs ``fn(rank, *args)`` in ``nproc`` processes started with
``torch.multiprocessing`` (the spawn method), each inside a process group
that meets at a ``file://`` rendezvous under ``workdir``.  Under NCCL each
rank takes card ``rank % device_count``; gloo ranks may share one card (gloo
copies CUDA tensors through the host itself and has no send/recv of them,
so they run the plan in allgather mode, :mod:`repro_torch.parallel.halo`),
which is no scaling measurement.

A rank that returns from ``fn`` waits at a barrier for the others, then
destroys the process group and collects garbage before its process exits.
The collection matters: an Engine on the Sharded plan sits in reference
cycles that hold its process groups, so without it
``destroy_process_group`` leaves each group's gloo threads running, and
the interpreter tears them down as it exits, which now and then aborts the
rank ("terminate called without an active exception").
"""
from __future__ import annotations

import gc
import os
import tempfile


def _entry(rank: int, fn, nproc: int, backend: str, path: str, args):
    import torch
    import torch.distributed as dist
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{path}",
                            world_size=nproc, rank=rank)
    try:
        fn(rank, *args)
        dist.barrier()      # a rank that raised skips it; spawn ends the rest
    finally:
        dist.destroy_process_group()
        gc.collect()        # the groups' threads stop here, not at exit


def spawn(fn, nproc: int, *args, backend: str = "gloo",
          workdir: str | None = None) -> None:
    """Run ``fn(rank, *args)`` on ``nproc`` ranks and wait for all of them
    (an exception in a rank is raised here).  ``fn`` must be importable by
    name (a module-level function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        path = os.path.join(d, "rendezvous")
        mp.spawn(_entry, args=(fn, nproc, backend, path, args),
                 nprocs=nproc, join=True)
