"""Multi-card dry run: count one step of every (arch x input shape x mesh)
cell on one rank of a fake 256- or 512-card world and extract the roofline
terms (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 forced host devices.
The port has no compile step: each cell's step runs once on shape-only
tensors of one rank inside a ``fake`` process group of the mesh's world
size, under :class:`repro_torch.utils.cost.CostCounter`, so the record
holds that rank's counted FLOPs and bytes, its collectives and its memory,
and :func:`repro_torch.launch.roofline.terms` under the H100's constants.
It allocates nothing on a device and launches no kernel.

* MD cells (arch ``fege-spinlattice``):
  :func:`repro_torch.launch.md_step.build_md_dryrun` runs one integrator
  step on fake tensors of the rank's slab; collectives come from the halo
  ledger.
* LM cells (:func:`lower_lm_cell`, every arch of ``configs.ARCHS`` x
  ``models.lm.SHAPES``): the parameters (and for a train cell the AdamW
  moments), the batch and the decode caches are meta tensors placed as
  DTensors on the production mesh by the port's sharding rules, and the
  cell runs the port's own entry point on them: ``train_step`` of
  ``make_train_step(mesh=, mode=)``, the prefill or the decode function of
  ``models.lm``.  DTensor runs each op on the rank's local meta shards,
  the flash-attention and SSD wrappers take their plain versions on meta
  tensors (their products are counted as the reference counts its
  ``chunked_attention`` and jnp ``ssd_chunked``), and the collectives are
  those DTensor and the expert-parallel MoE issue, by HLO kind.

One JSON record per cell goes to ``experiments/dryrun/``:

  meta          kind, tokens, dtype (LM: the config's, so that the
                roofline takes the bf16 peak); MD: atoms, capacity, ...
  memory        argument / output bytes: the rank's shards (state, batch,
                caches), temp bytes the peak of live tensors during the
                step; ``card`` names the card it is held to
  collectives   per kind: calls and per-rank bytes
  roofline      compute / memory / collective terms

``flops_xla_body`` and ``bytes_xla_body`` (XLA's count of a loop body
once) and ``generated_code_bytes`` have no counterpart and are None.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape train_4k [--multi-pod] [--plan '{"accum": 4}']
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all

``--all`` runs the reference's set: every LM arch x shape and the MD
cells, on the 16x16 and 2x16x16 worlds, each world in a child process of
its own (the two at once), so no process group outlives its cells.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import heapq
import json
import math
import os
import time
import traceback

from repro_torch.launch import roofline
from repro_torch.launch.md_step import MD_SHAPES
from repro_torch.launch.mesh import (dp_axes, dp_size, make_production_mesh,
                                     mesh_shape, production_shape, tp_size)
from repro_torch.utils.collectives import collectives_with_trips

# the card a record's memory is held to (NVIDIA's H100 SXM data sheet)
CARD = {"name": "NVIDIA H100 SXM", "hbm_bytes": 80e9}


@dataclasses.dataclass
class RunPlan:
    """Per-cell knobs, the reference's with its defaults.  ``kv_chunk``
    and ``donate`` have no effect in the port (the flash kernels replace
    the reference's ``chunked_attention``, and the step updates its state
    in place); they stay in the record."""
    accum: int = 8                 # gradient-accumulation microbatches
    remat: bool = True
    kv_chunk: int = 1024
    xent_chunk: int = 2048
    opt_dtype: str = "float32"     # bf16 for the 671B MoE
    cache_dtype: str = "bfloat16"
    donate: bool = True
    moe_impl: str = "auto"         # 'dense' baseline | 'auto' / 'ep'
    sharding: str = "tp"           # 'tp' | 'fsdp' | 'dp' parameter ruleset
    grad_dtype: str = "float32"
    md_impl: str = "stencil"       # 'stencil' baseline | 'pruned' prestaged


# arch/shape-specific overrides (the reference's)
PLAN_OVERRIDES: dict[tuple[str, str], dict] = {
    ("deepseek-v3-671b", "train_4k"): dict(accum=8, opt_dtype="bfloat16"),
    ("pixtral-12b", "train_4k"): dict(accum=8),
    ("qwen2-7b", "prefill_32k"): dict(kv_chunk=2048),
}


def plan_for(arch: str, shape: str, overrides: dict | None = None) -> RunPlan:
    """The default plan with the cell's :data:`PLAN_OVERRIDES`, then
    ``overrides``; an unknown knob raises."""
    plan = RunPlan()
    for src in (PLAN_OVERRIDES.get((arch, shape), {}), overrides or {}):
        for k, v in src.items():
            if not hasattr(plan, k):
                raise ValueError(f"unknown plan knob {k!r}")
            setattr(plan, k, v)
    return plan


def all_cells() -> list[tuple[str, str]]:
    """The reference's ``--all`` set: every LM arch x shape, then the MD
    cells."""
    from repro_torch import configs
    from repro_torch.models.lm import SHAPES
    return ([(a, s) for a in configs.ARCHS for s in SHAPES]
            + [("fege-spinlattice", s) for s in MD_SHAPES])


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


# ---------------------------------------------------------------------------
# DTensor on the host, as the card runs it
# ---------------------------------------------------------------------------

def _resumable_min_cost_path(self, src_state, dst_state):
    """``DTensorRedistributePlanner.find_min_cost_path`` with its search
    kept per (planner, source, target sets): the same Dijkstra, with the
    same tie-breaking counter, resumed where the last query from the same
    source stopped, so each state's path is the one the original returns
    (the first time a state is popped)."""
    from torch.distributed.tensor import _redistribute as rd
    key = (src_state, frozenset(self.strided_shard_placements_in_target),
           frozenset(self.partial_reduce_ops_in_target))
    runs = self.__dict__.setdefault("_dryrun_paths", {})
    run = runs.get(key)
    if run is None:
        run = runs[key] = {"pq": [(0.0, 0, 0.0, src_state, [src_state])],
                           "visited": set(), "first": {}, "counter": 0}
    first, pq, visited = run["first"], run["pq"], run["visited"]
    if dst_state in first:
        return first[dst_state]
    while pq:
        _, _, cost, cur, path = heapq.heappop(pq)
        first.setdefault(cur, path)
        if cur not in visited:
            # expanded before a return too: the next query resumes here
            visited.add(cur)
            for nxt, step_cost in self.get_next_state(
                    cur.placements, cur.tensor_dim_to_mesh_dim).items():
                if nxt not in visited:
                    new = cost + step_cost
                    run["counter"] += 1
                    heapq.heappush(pq, (rd._redistribute_cost_sort_key(new),
                                        run["counter"], new, nxt,
                                        path + [nxt]))
        if cur == dst_state:
            return first[cur]
    raise AssertionError(f"No path found from src_state {src_state} to "
                         f"dst_state {dst_state}")


def _memo_next_state(orig):
    def next_state(self, placements, order):
        key = (placements, order,
               frozenset(self.strided_shard_placements_in_target),
               frozenset(self.partial_reduce_ops_in_target))
        memo = self.__dict__.setdefault("_dryrun_next", {})
        if key not in memo:
            memo[key] = orig(self, placements, order)
        return memo[key]
    return next_state


def _card_shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(i) -> Shard(j) as a CUDA mesh runs it: one
    all-to-all (on a CPU mesh DTensor falls back to an all-gather and a
    chunk)."""
    import torch
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def card_dtensor():
    """Inside the block, DTensor plans and moves shards as on the card,
    only faster: the redistribution planner's Dijkstra (torch >= 2.10,
    which searches a fresh graph for every candidate strategy of an op
    whose inputs carry a ``_StridedShard``) answers from one resumable
    search per source state and memoised transitions, which returns the
    same paths; and a Shard -> Shard move takes the all-to-all a CUDA
    mesh takes.  Each piece is applied only where this torch has what it
    replaces."""
    from torch.distributed.tensor import _redistribute as rd
    from torch.distributed.tensor import placement_types as pt
    saved = []
    planner = getattr(rd, "DTensorRedistributePlanner", None)
    if planner is not None and all(
            hasattr(planner, n) for n in ("find_min_cost_path",
                                          "get_next_state")) and hasattr(
            rd, "_redistribute_cost_sort_key"):
        saved += [(planner, "find_min_cost_path",
                   planner.find_min_cost_path),
                  (planner, "get_next_state", planner.get_next_state)]
        planner.find_min_cost_path = _resumable_min_cost_path
        planner.get_next_state = _memo_next_state(planner.get_next_state)
    import torch
    if hasattr(pt, "shard_dim_alltoall") and hasattr(
            torch.ops._dtensor, "shard_dim_alltoall"):
        saved.append((pt, "shard_dim_alltoall", pt.shard_dim_alltoall))
        pt.shard_dim_alltoall = _card_shard_dim_alltoall
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def place_tree(tree, placements, mesh):
    """Each meta leaf of ``tree`` as a DTensor at its placements (every
    rank keeps its own shard, no communication)."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: place_tree(v, placements[k], mesh)
                for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of ``tree`` (DTensors, plain tensors,
    nested dicts / lists / tuples)."""
    import torch
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def cache_shardings(mesh, caches) -> dict:
    """The reference's ``_cache_shardings``: each cache leaf (L, B, ...)
    with its batch dimension over the data-parallel dimensions where it
    divides them, and dimension 3, else 4, over "model" where it
    divides."""
    from repro_torch.parallel.sharding import placements
    dp = dp_axes(mesh)
    dpn = dp_size(mesh)
    tp = tp_size(mesh)

    def spec(x):
        s = [None] * x.dim()
        if x.dim() >= 2 and x.shape[1] % dpn == 0 and x.shape[1] >= dpn:
            s[1] = dp if len(dp) > 1 else dp[0]
        for d in (3, 4):
            if x.dim() > d and x.shape[d] % tp == 0 and x.shape[d] >= tp:
                s[d] = "model"
                break
        return placements(mesh, tuple(s))

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else spec(t)
    return walk(caches)


def lower_lm_cell(arch: str, shape_name: str, mesh, plan: RunPlan) -> dict:
    """Count one LM cell on this rank (reference ``lower_lm_cell``):
    returns the record's meta with ``op_cost``, ``ops``, ``ledger`` (the
    counter's collectives) and ``memory``, or ``{"skipped": reason}``."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import (batch_to_mesh,
                                              init_train_state,
                                              make_train_step,
                                              shard_train_state)
    from repro_torch.utils.cost import CostCounter

    cfg = configs.get(arch)
    if cfg.moe is not None and plan.moe_impl != cfg.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=plan.moe_impl)
    shape = lm.SHAPES[shape_name]
    ok, reason = lm.shape_applicable(cfg, shape)
    if not ok:
        return {"skipped": reason}
    mode = plan.sharding
    params = lm.abstract_params(cfg, tp=tp_size(mesh))
    batch = lm.input_specs(cfg, shape)
    batch_args = _local_bytes(batch_to_mesh(batch, mesh)) if batch else 0
    meta = {"kind": shape.kind, "dtype": cfg.dtype,
            "tokens": shape.global_batch * (
                1 if shape.kind == "decode" else shape.seq_len)}
    counter = CostCounter()
    if shape.kind == "train":
        state = shard_train_state(
            init_train_state(params, getattr(torch, plan.opt_dtype)), mesh,
            mode)
        args = _local_bytes([state.params, state.opt.mu, state.opt.nu]) \
            + batch_args
        step = make_train_step(
            lm.make_loss_fn(cfg, remat=plan.remat,
                            xent_chunk=plan.xent_chunk),
            lambda s: cosine_schedule(s, peak_lr=3e-4, warmup=100,
                                      total=10000),
            accum=plan.accum, grad_dtype=getattr(torch, plan.grad_dtype),
            mesh=mesh, mode=mode)
        with counter:
            state, metrics = step(state, batch)
            out = _local_bytes([state.params, state.opt.mu, state.opt.nu,
                                metrics["loss"], metrics["grad_norm"]])
    else:
        pl = sh.param_shardings(mesh, params, mode)
        p_in = place_tree(params, pl, mesh)
        args = _local_bytes(p_in) + batch_args
        with sh.use_mesh(mesh, mode), torch.no_grad():
            b_in = batch_to_mesh(batch, mesh)
            if shape.kind == "prefill":
                fn = lm.make_prefill_fn(cfg)
                with counter:
                    logits = fn(p_in, b_in)
                    out = _local_bytes(logits)
            else:
                caches = lm.cache_specs(cfg, shape,
                                        getattr(torch, plan.cache_dtype))
                c_in = place_tree(caches, cache_shardings(mesh, caches), mesh)
                args += _local_bytes(c_in)
                fn = lm.make_decode_fn(cfg)
                with counter:
                    logits, c_out = fn(p_in, c_in, b_in)
                    out = _local_bytes([logits, c_out])
    rec = counter.record()
    meta.update({
        "op_cost": {k: rec[k] for k in ("flops", "bytes_naive",
                                        "bytes_anchor")},
        "ops": rec["ops"], "ledger": rec["collectives"],
        "memory": {"argument_bytes": args, "output_bytes": out,
                   "temp_bytes": rec["peak_bytes"],
                   "generated_code_bytes": None}})
    return meta


# ---------------------------------------------------------------------------
# MD (the paper's workload)
# ---------------------------------------------------------------------------

def lower_md_cell(shape_name: str, mesh, plan: RunPlan) -> dict:
    import torch

    from repro_torch.launch.md_step import build_md_dryrun
    return build_md_dryrun(shape_name, mesh, dtype=torch.float32,
                           impl=plan.md_impl)


# ---------------------------------------------------------------------------
# analysis + records
# ---------------------------------------------------------------------------

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
        "flops_xla_body": None,
        # anchor bytes: product / gather / scatter-class traffic; naive =
        # every op's in + out (an upper bound)
        "bytes_total": float(cost["bytes_anchor"]),
        "bytes_naive": float(cost["bytes_naive"]),
        "bytes_xla_body": None,
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
            plan = plan_for(arch, shape_name, overrides)
            if arch == "fege-spinlattice":
                meta = lower_md_cell(shape_name, mesh, plan)
            else:
                with card_dtensor():
                    meta = lower_lm_cell(arch, shape_name, mesh, plan)
            if "skipped" in meta:
                rec = {"arch": arch, "shape": shape_name, "mesh": mshape,
                       "skipped": meta["skipped"]}
            else:
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
    elif "skipped" in rec:
        print(f"SKIP {tag}: {rec['skipped']}", flush=True)
    else:
        r = rec["roofline"]
        print(f"OK   {tag}  flops={rec['flops_total']:.3e} "
              f"coll={r['collective_bytes']:.3e}B "
              f"bound={r['bottleneck']} ({rec['elapsed_s']}s)", flush=True)
    return rec


def _world(multi_pod: bool, cells, out_dir, overrides) -> None:
    """One world's cells (a child process of ``--all``)."""
    import torch
    torch.set_num_threads(1)
    with fake_world(math.prod(production_shape(multi_pod).values())):
        for arch, shape in cells:
            run_cell(arch, shape, multi_pod, out_dir, overrides)


def run_all(out_dir: str = "experiments/dryrun",
            overrides: dict | None = None, cells=None) -> None:
    """``cells`` (default :func:`all_cells`) in fake worlds, each world in
    a child process, all at once; raises if a child fails (a cell's own
    failure is its record).  A cell is ``(arch, shape)``, run on both the
    16x16 and the 2x16x16 world, or ``(arch, shape, multi_pod)``, run on
    that one."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    cells = all_cells() if cells is None else cells
    worlds = {pod: [tuple(c[:2]) for c in cells
                    if len(c) == 2 or bool(c[2]) == pod]
              for pod in (False, True)}
    procs = [ctx.Process(target=_world, args=(pod, todo, out_dir,
                                              overrides))
             for pod, todo in worlds.items() if todo]
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
