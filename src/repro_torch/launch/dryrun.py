"""Multi-card dry run of the MD cells: count one step on one rank of a
fake 256- or 512-card world and extract the roofline terms (port of
``repro.launch.dryrun``, its MD half).

The reference lowers and compiles each cell for 512 forced host devices.
The port has no compile step: each cell's step runs once on one rank's
slab of fake tensors inside a ``fake`` process group of the mesh's world
size (:func:`repro_torch.launch.md_step.build_md_dryrun`), so the record
holds that rank's counted FLOPs and bytes (:mod:`repro_torch.utils.cost`),
its collectives (the halo ledger) and its memory, and
:func:`repro_torch.launch.roofline.terms` under the H100's constants.  It
allocates nothing on a device.  One JSON record per cell goes to
``experiments/dryrun/``:

  meta          atoms, atoms per rank, cells, capacity, op counts
  memory        argument / output bytes from the shapes, temp bytes the
                peak of live fake tensors during the step; ``card`` names
                the card whose memory it is held to
  collectives   per ledger tag: calls and per-rank bytes
  roofline      compute / memory / collective terms

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fege-spinlattice \\
      --shape md_small [--multi-pod] [--plan '{"md_impl": "pruned"}']
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

``--all`` runs every MD cell on the 16x16 and 2x16x16 worlds, each world
in a child process of its own (the two at once), so no process group
outlives its cells.  The LM cells are ROADMAP item 15.7: the port serves
every LM arch on one card, but lowering one on the production mesh needs
``input_specs``, ``cache_specs``, ``abstract_params`` and the sharding
rules, which come with it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.launch import roofline
from repro_torch.launch.md_step import MD_SHAPES
from repro_torch.launch.mesh import (make_production_mesh, mesh_shape,
                                     production_shape)
from repro_torch.utils.collectives import collectives_with_trips

# the card a record's memory is held to (NVIDIA's H100 SXM data sheet)
CARD = {"name": "NVIDIA H100 SXM", "hbm_bytes": 80e9}


@dataclasses.dataclass
class RunPlan:
    """Per-cell knobs."""
    md_impl: str = "stencil"       # 'stencil' baseline | 'pruned' prestaged


def plan_for(arch: str, shape: str, overrides: dict | None = None) -> RunPlan:
    plan = RunPlan()
    for k, v in (overrides or {}).items():
        if not hasattr(plan, k):
            raise ValueError(f"unknown plan knob {k!r}")
        setattr(plan, k, v)
    return plan


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks (this process is rank 0)
    for the block's duration, unless a world is already initialised."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def lower_md_cell(shape_name: str, mesh, plan: RunPlan) -> dict:
    import torch

    from repro_torch.launch.md_step import build_md_dryrun
    return build_md_dryrun(shape_name, mesh, dtype=torch.float32,
                           impl=plan.md_impl)


def analyze(meta: dict, arch: str, shape_name: str, mesh) -> dict:
    """The record of a counted cell (every quantity per rank)."""
    n_dev = int(mesh.mesh.numel())
    cost = meta.pop("op_cost")
    coll = collectives_with_trips(meta.pop("ledger"))
    mem = meta.pop("memory")
    temp = mem["temp_bytes"]
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_shape(mesh),
        "devices": n_dev,
        "meta": meta,
        "flops_total": float(cost["flops"]),
        # anchor bytes: product / gather / scatter-class traffic; naive =
        # every op's in + out (an upper bound)
        "bytes_total": float(cost["bytes_anchor"]),
        "bytes_naive": float(cost["bytes_naive"]),
        "collectives": coll["per_kind"],
        "collective_trips_unknown": coll["unknown_trips"],
        "memory": mem,
        "card": {**CARD, "fits": (mem["argument_bytes"] + temp
                                  <= CARD["hbm_bytes"])},
    }
    rec["roofline"] = roofline.terms(rec)
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = "experiments/dryrun",
             overrides: dict | None = None) -> dict:
    """Count one cell in a fake world of the production mesh's size (or
    the initialised world) and write its record."""
    mshape = production_shape(multi_pod)
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    t0 = time.time()
    with fake_world(math.prod(mshape.values())):
        try:
            mesh = make_production_mesh(multi_pod=multi_pod)
            if arch != "fege-spinlattice":
                raise NotImplementedError(
                    f"the dry run's LM cells ({arch}) are ROADMAP item 15.7")
            plan = plan_for(arch, shape_name, overrides)
            meta = lower_md_cell(shape_name, mesh, plan)
            rec = analyze(meta, arch, shape_name, mesh)
            rec["plan"] = dataclasses.asdict(plan)
        except Exception as e:     # a cell's failure is its record
            rec = {"arch": arch, "shape": shape_name, "mesh": mshape,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
    rec["elapsed_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    if "error" in rec:
        print(f"FAIL {tag}: {rec['error']}", flush=True)
    else:
        r = rec["roofline"]
        print(f"OK   {tag}  flops={rec['flops_total']:.3e} "
              f"coll={r['collective_bytes']:.3e}B "
              f"bound={r['bottleneck']} ({rec['elapsed_s']}s)", flush=True)
    return rec


def _world(multi_pod: bool, cells, out_dir, overrides) -> None:
    """One world's cells (a child process of ``--all``)."""
    with fake_world(math.prod(production_shape(multi_pod).values())):
        for arch, shape in cells:
            run_cell(arch, shape, multi_pod, out_dir, overrides)


def run_all(out_dir: str = "experiments/dryrun",
            overrides: dict | None = None) -> None:
    """Every MD cell on both worlds, each world in a child process, the
    two at once; raises if a child fails."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    cells = [("fege-spinlattice", s) for s in MD_SHAPES]
    procs = [ctx.Process(target=_world, args=(pod, cells, out_dir,
                                              overrides))
             for pod in (False, True)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dry-run worlds exited with {bad}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--plan", default=None, help="JSON plan overrides")
    args = ap.parse_args(argv)
    overrides = json.loads(args.plan) if args.plan else None
    if args.all:
        run_all(args.out, overrides)
        return 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                   overrides)
    return 1 if "error" in rec else 0


if __name__ == "__main__":
    raise SystemExit(main())
