"""One run of a cell: set-up, the measured window, the check, the metrics.

A cell on one card runs in this process; a cell on several runs one rank a
card, each a process of its own in one ``torch.distributed`` world (NCCL
between the cards, with a gloo group beside it for the harness's host-side
gathers; gloo alone in a rehearsal on the CPU), met at a free localhost
port.  Rank 0 checks and reports; the result comes back to this process
through a file in a temporary directory.

Set-up (``setup_s``, from this process's start to the window's) holds the
interpreter and torch, the kernels' build or load, the ranks' start, the
inputs, the engine, the check's first steps and one warm chunk of the
cell's own shapes.  The window runs ``Engine.run(chunk)`` until
``--seconds`` have passed (on several cards, until rank 0 says so after a
chunk) and ends in a synchronize; with ``--trace 1`` each rank runs it
under ``torch.profiler``.  The peak of device memory is read when the
window closes, before the step the check takes after it; the program is
then freed and the reference runs on rank 0.

The metrics: every reader (``perfbench/metrics/<name>.py``) reads each
rank's ``ctx`` (its trace, its counters over the window, its peak), and
the ranks' readings combine by the reader's ``COMBINE`` (the mean unless
it says ``max``).
"""
from __future__ import annotations

import gc
import json
import os
import socket
import sys
import tempfile
import time

import torch

from perfbench.harness import check, manifest, program, trace

REHEARSAL_CELLS = (4, 4, 4)     # a rank's box on the CPU, in unit cells
REHEARSAL_CHUNK = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list:
    """The top-level modules of :data:`FORBIDDEN` this process holds,
    compared by whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cells_of(cell: dict, args) -> tuple:
    """The run's box in unit cells: the mix's, or in a rehearsal a 4^3 box
    a rank, the ranks along x."""
    if args.rehearse:
        world = int(cell["workload"]["chips"])
        return (REHEARSAL_CELLS[0] * world,) + REHEARSAL_CELLS[1:]
    return tuple(cell["traffic"]["unit_cells"])


def _device(args, rank: int):
    return torch.device("cpu") if args.rehearse else torch.device("cuda",
                                                                  rank)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _kind(device) -> dict:
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu"}


def run(cell: dict, args, t_start: float, hook=None) -> dict:
    """The run's result (with ``check_rows``, each compared number and its
    limit).  ``hook``, a picklable callable, runs in every rank before
    anything is built (the tests plant faults with it)."""
    if args.control:
        return _control(cell, args)
    world = int(cell["workload"]["chips"])
    if not args.rehearse:
        from repro_torch import _build
        _build.build(list(manifest.model(cell["config"]).KERNELS))
    if world == 1:
        return _rank_run(0, 1, cell, args, t_start, None, hook)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        mp.spawn(_rank, args=(world, cell, args, t_start, _address(), out,
                              hook), nprocs=world, join=True)
        with open(out) as f:
            return json.load(f)


def _address() -> str:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def _rank(rank, world, cell, args, t_start, address, out, hook):
    """One rank of a run over several cards (``torch.multiprocessing``
    spawns it); rank 0 writes the result to ``out``."""
    import torch.distributed as dist
    device = _device(args, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=rank)
    group = dist.new_group(backend="gloo") if backend == "nccl" else None
    try:
        result = _rank_run(rank, world, cell, args, t_start, group, hook)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)


def _stop(seconds: float, group, world: int):
    """Whether the window ends after this chunk: on several ranks rank 0's
    clock decides, sent to the others over the host-side group."""
    if world == 1:
        return lambda elapsed: elapsed >= seconds
    import torch.distributed as dist

    def stop(elapsed):
        flag = torch.tensor([int(elapsed >= seconds)])
        dist.broadcast(flag, 0, group=group)
        return bool(flag.item())
    return stop


def _barrier(group, world: int):
    if world > 1:
        import torch.distributed as dist
        dist.barrier(group=group)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _rank_run(rank, world, cell, args, t_start, group, hook):
    config, traffic = cell["config"], cell["traffic"]
    model, plan = manifest.model(config), manifest.plan(traffic["plan"])
    device = _device(args, rank)
    cells = cells_of(cell, args)
    chunk = int(traffic["chunk"])
    if args.rehearse:
        chunk = min(chunk, REHEARSAL_CHUNK)
    if hook is not None:
        hook()
    keep = rank == 0
    eng, gen, rec = program.setup(config, traffic, model, plan, cells,
                                  args.seed, rank, group, device)
    eng.run(chunk, gen, chunk=chunk)             # warm the chunk's shapes
    _sync(device)
    _barrier(group, world)
    setup_s = time.perf_counter() - t_start
    stop = _stop(args.seconds, group, world)
    c0 = plan.counters(eng)
    holder = None
    if args.trace:
        with trace.traced() as holder:
            win = program.window(eng, gen, chunk, stop, device)
    else:
        win = program.window(eng, gen, chunk, stop, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if keep:
        print(f"perfbench: window {win['steps']} steps, {win['chunks']} "
              f"chunks, {win['rebuilds']} rebuilds, {win['seconds']:.3f} s; "
              f"set-up {setup_s:.2f} s", file=sys.stderr)
    part = {"setup_s": setup_s, "window": win, "peak_bytes": peak,
            "counters": _delta(plan.counters(eng), c0),
            "trace": holder.trace if holder is not None else None}
    program.finish(eng, gen, plan, group, rec, keep)
    del eng, gen
    _free(device)
    if world > 1:
        import torch.distributed as dist
        parts = [None] * world if keep else None
        dist.gather_object(part, parts, dst=0, group=group)
    else:
        parts = [part]
    if not keep:
        return None
    out = _conclude(cell, args, model, cells, rec, parts, device)
    out["forbidden"] = loaded_forbidden()
    return out


def _pairs(config, traffic, cells, seed, device) -> int:
    """Ordered pairs inside the cutoff in the starting crystal, counted by
    the reference's own search."""
    from perfbench.harness import inputs
    from perfbench.reference import neighbors
    inp = inputs.state(config, traffic, cells, seed, device)
    _, mask = neighbors.neighbor_list(inp["pos"], inp["box"],
                                      config["potential"]["cutoff"])
    return int(mask.sum())


def _combine(values: list, how: str):
    values = [v for v in values if v is not None]
    if not values:
        return None
    return max(values) if how == "max" else sum(values) / len(values)


def _conclude(cell, args, model, cells, rec, parts, device) -> dict:
    """Rank 0, the program freed: the check, then the metrics."""
    config, traffic = cell["config"], cell["traffic"]
    chips = int(cell["workload"]["chips"])
    t_check = time.perf_counter()
    n_pairs = _pairs(config, traffic, cells, args.seed, device)
    numbers = check.compare(config, model, traffic, cells, args.seed, rec,
                            device)
    print(f"perfbench: the check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    ok, rows = check.verdict(numbers, cell["limits"])
    n_atoms = int(rec["pre"]["pos"].shape[0])
    # one card's share of an evaluation: its atoms and their pairs
    work = model.work_of(config, n_atoms // chips, n_pairs // chips)
    ctxs = [{"workload": cell["workload"], "config": config,
             "traffic": traffic, "atoms": n_atoms, "chips": chips,
             "n_pairs": n_pairs, "work": work, **p} for p in parts]
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell["metrics"][kind]:
        read, how = manifest.reader(m["name"])
        value = _combine([read(c) for c in ctxs], how)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    win = parts[0]["window"]
    dev = {**_kind(device), "count": chips,
           "memory_peak_bytes": max(p["peak_bytes"] for p in parts)}
    out = {"correct": ok, "attempted": win["steps"], "failed": 0,
           "metrics": metrics, "device": dev}
    traces = [p["trace"] for p in parts if p["trace"] is not None]
    if traces:
        dev["busy_s"] = sum(t.busy_s() for t in traces) / len(traces)
        dev["window_s"] = sum(t.window_s for t in traces) / len(traces)
        out["breakdown"] = traces[0].breakdown()
    out["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    out["check_rows"] = rows
    return out


def _control(cell, args) -> dict:
    """The control: no program, no window; the reference with TF32
    contractions in the program's place, held to the cell's limits, on one
    card (or the CPU)."""
    config, traffic = cell["config"], cell["traffic"]
    device = _device(args, 0)
    model = manifest.model(config)
    cells = cells_of(cell, args)
    rec = check.control_record(config, model, traffic, cells, args.seed,
                               device)
    numbers = check.compare(config, model, traffic, cells, args.seed, rec,
                            device)
    ok, rows = check.verdict(numbers, cell["limits"])
    return {"correct": ok, "attempted": 0, "failed": 0, "metrics": {},
            "device": {**_kind(device), "count": 1, "memory_peak_bytes": 0},
            "check": {k: {"value": v, "limit": lim} for k, v, lim in rows},
            "check_rows": rows}
