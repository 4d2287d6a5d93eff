"""Training and simulation driver (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
        --steps 200 --batch 8 --seq 512 [--smoke] [--ckpt-dir ckpts]
    PYTHONPATH=src python -m repro_torch.launch.train --arch fege-spinlattice \\
        --steps 500 --cells 6 --temperature 160

LM (``--arch`` of the zoo, any family): random weights from ``--seed``
(tp = 1), the synthetic token stream of ``data/tokens.py``,
``make_loss_fn`` (remat, 512-row loss chunks) through the flash kernels'
forward and backward for attention and the SSD chunk kernels' forward and
backward for the Mamba-2 blocks (ssm, hybrid), ``make_train_step`` with ``--accum`` microbatches
and AdamW under a cosine schedule (warmup 20).  It prints every
``--log-every`` step's loss, learning rate, gradient norm and tokens/s.
``--ckpt-dir`` saves the train state every ``--ckpt-every`` steps and at
the end, and a relaunch resumes from the newest complete checkpoint, the
data stream seeked to the resumed step (the reference restarts its stream
at batch 0).

On a mesh (``--mesh data=2`` / ``model=2`` / ``pod=2,data=2,model=2``,
``--sharding tp|fsdp|dp``, ``--backend nccl|gloo``) ``train_lm`` starts
one rank per mesh position through ``parallel/ranks.py:spawn``: NCCL with
one card a rank when the machine has a card for each (the default then),
else gloo ranks, which share the one card (no scaling measurement) or run
on the host with ``--device cpu``.  Every rank builds the same full
parameters from ``--seed`` at tp = the mesh's "model" size (``--tp``
overrides it; a one-device run compared with a mesh run must use the
same), keeps its shard (``train/train_step.py:shard_train_state``) and
takes the same global batch, each microbatch's rows split over the
data-parallel dimensions; rank 0 prints the loss, gradient norm, global
tokens/s and each rank's peak memory.  A mesh run keeps no checkpoint.

MD (``--arch fege-spinlattice``): fits NEP-SPIN to synthetic
constrained-DFT data (24 B20 2x2x2 configurations labeled by the
Heisenberg-DMI oracle, Adam for ``--fit-steps``), then runs coupled
spin-lattice MD with the fitted weights on a ``--cells``^3 B20 supercell,
printing E, T and the topological charge every 50 steps and the helix
pitch at the end.  ``--use-kernel`` (the default on a card) routes the MD
through the hand-written K1/K2 kernels
(``NEPSpinPotential(use_kernel=True)``); ``--device cpu`` runs on the
host, for either half.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.utils.device import resolve_device

MD_ARCH = "fege-spinlattice"
MESH_DIMS = ("pod", "data", "model")
# the training state a parameter holds on the card: bf16 weight, its bf16
# gradient from the backward, the f32 accumulation buffer and the two f32
# AdamW moments
TRAIN_BYTES_PER_PARAM = 2 + 2 + 4 + 8


def depth_cut(cfg, n: int):
    """``cfg`` at ``n`` layers.  An MoE arch keeps its leading dense layers
    first (cut to its first ``n`` dense layers when ``n`` does not reach
    past them); an encoder-decoder cuts its encoder and decoder alike."""
    import dataclasses
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=n,
                                   encoder_layers=min(n, cfg.encoder_layers))
    if cfg.moe is not None and n <= cfg.moe.first_dense:
        return dataclasses.replace(cfg, n_layers=n, moe=dataclasses.replace(
            cfg.moe, first_dense=n))
    return dataclasses.replace(cfg, n_layers=n)


def fit_depth(cfg, budget_gib: float, nbytes_of, min_layers: int = 1):
    """``cfg`` cut (``depth_cut``) to the most layers, at least
    ``min_layers``, whose ``nbytes_of(cut)`` fits ``budget_gib``.  Returns
    (cut, GiB); raises ValueError when not even ``min_layers`` fit."""
    for n in range(cfg.n_layers, min_layers - 1, -1):
        c = depth_cut(cfg, n)
        gib = nbytes_of(c) / 2 ** 30
        if gib <= budget_gib:
            return c, gib
    raise ValueError(f"{cfg.name}: not {min_layers} layers fit "
                     f"{budget_gib} GiB")


def train_depth(cfg, budget_gib: float):
    """``cfg`` at the most layers whose training state,
    ``TRAIN_BYTES_PER_PARAM`` a parameter of the model :func:`train_lm`
    builds (tp = 1, from the meta device), fits ``budget_gib``.  Returns
    (cfg, GiB of its training state)."""
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_count
    return fit_depth(cfg, budget_gib, lambda c: tree_count(
        lm.abstract_params(c, tp=1)) * TRAIN_BYTES_PER_PARAM)


def parse_mesh(spec: str | None) -> dict:
    """``"data=2,model=1"`` -> {"data": 2, "model": 1}, in mesh order
    (pod, data, model); None or "" -> {}."""
    if not spec:
        return {}
    got = {}
    for part in spec.split(","):
        name, _, n = part.partition("=")
        if name not in MESH_DIMS or not n.isdigit() or int(n) < 1:
            raise ValueError(f"--mesh {spec!r}: want name=size with names "
                             f"from {MESH_DIMS}")
        got[name] = int(n)
    return {a: got[a] for a in MESH_DIMS if a in got}


def mesh_world(args) -> int:
    return math.prod(parse_mesh(getattr(args, "mesh", None)).values())


def train_lm(args, cfg_override=None) -> dict:
    """The LM training loop; returns the config, the final state and each
    step's metrics (floats) with its wall time and tokens/s.  With a mesh
    of more than one position the ranks train in processes of their own
    and rank 0's rows come back (no state)."""
    if mesh_world(args) > 1:
        return train_lm_mesh(args, cfg_override)
    from repro_torch import configs
    from repro_torch.ckpt.checkpoint import (latest_step, load_checkpoint,
                                             save_checkpoint)
    from repro_torch.data.tokens import synthetic_batches, to_tensors
    from repro_torch.models import lm
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_count

    dev = resolve_device(args.device)
    cfg = cfg_override or (configs.get_smoke(args.arch) if args.smoke
                           else configs.get(args.arch))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, tp=getattr(args, "tp", None) or 1,
                            device=dev)
    print(f"arch={cfg.name} params={tree_count(params) / 1e6:.1f}M "
          f"device={dev}", flush=True)
    state = init_train_state(params)
    loss_fn = lm.make_loss_fn(cfg, remat=True, xent_chunk=512)
    step_fn = make_train_step(
        loss_fn, lambda s: cosine_schedule(s, peak_lr=args.lr, warmup=20,
                                           total=args.steps),
        accum=args.accum)

    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = load_checkpoint(args.ckpt_dir, state)
        start += 1
        print(f"resumed from step {start}", flush=True)

    batches = synthetic_batches(cfg, args.batch, args.seq, args.seed,
                                start=start)
    tokens = args.batch * args.seq
    rows, t_all, pending = [], 0.0, None
    for i in range(start, args.steps):
        batch = to_tensors(next(batches), dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        row = {"step": i, "loss": float(metrics["loss"]),
               "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"])}
        _sync(dev)
        row["s"] = time.perf_counter() - t0
        row["tokens_per_s"] = tokens / row["s"]
        rows.append(row)
        t_all += row["s"]
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {row['loss']:.4f} lr {row['lr']:.2e} "
                  f"gnorm {row['grad_norm']:.3f} tok/s "
                  f"{tokens * len(rows) / t_all:.0f}", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_checkpoint(args.ckpt_dir, i, state, async_=True)
    if pending is not None:
        pending.join()
    if args.ckpt_dir and latest_step(args.ckpt_dir) != args.steps - 1:
        save_checkpoint(args.ckpt_dir, args.steps - 1, state)
    return {"cfg": cfg, "state": state, "rows": rows, "start": start}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_backend(args) -> str:
    """``--backend``, or NCCL when every rank has a card of its own."""
    if getattr(args, "backend", None):
        return args.backend
    n = mesh_world(args)
    if args.device != "cpu" and torch.cuda.is_available() and \
            torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def train_lm_mesh(args, cfg_override=None) -> dict:
    """``train_lm`` on ``--mesh``: spawn the ranks, return rank 0's
    result (the config, the rows, each rank's peak memory)."""
    import json
    import os
    import tempfile
    from repro_torch.parallel.ranks import spawn
    if args.ckpt_dir:
        raise ValueError("a mesh run keeps no checkpoint (--ckpt-dir)")
    backend = mesh_backend(args)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        spawn(_mesh_rank, mesh_world(args), args, cfg_override, out,
              backend=backend, workdir=d)
        with open(out) as f:
            res = json.load(f)
    from repro_torch import configs
    res["cfg"] = cfg_override or (configs.get_smoke(args.arch) if args.smoke
                                  else configs.get(args.arch))
    return res


def _mesh_rank(rank, args, cfg_override, out) -> None:
    import json
    res = train_lm_on_mesh(args, cfg_override, make_mesh(args))
    if rank == 0:
        with open(out, "w") as f:
            json.dump({k: v for k, v in res.items()
                       if k not in ("cfg", "state")}, f)


def make_mesh(args):
    """The DeviceMesh of ``--mesh`` over the initialised world (on the
    card each rank uses: its own under NCCL, the one shared under gloo,
    whose all-gathers of CUDA tensors are then staged through the host:
    ``sharding.stage_gloo_all_gather``), or on the host with ``--device
    cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.parallel.sharding import stage_gloo_all_gather
    shape = parse_mesh(args.mesh)
    kind = "cpu" if args.device == "cpu" else "cuda"
    if kind == "cuda" and dist.get_backend() != "nccl":
        torch.cuda.set_device(0)
        stage_gloo_all_gather()
    return DeviceMesh(kind, torch.arange(math.prod(shape.values())).reshape(
        tuple(shape.values())), mesh_dim_names=tuple(shape))


def train_lm_on_mesh(args, cfg_override, mesh) -> dict:
    """One rank's training loop on ``mesh`` (every rank calls it): the
    same full parameters on every rank from ``--seed``, sharded by
    ``--sharding``'s rules, the same global batches.  Returns the config,
    the final (sharded) state, the rows (loss, gradient norm, wall time,
    global tokens/s, the gradient reduction's seconds) and each rank's
    peak memory in GiB (gathered: the same on every rank)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_batches, to_tensors
    from repro_torch.launch.mesh import tp_size
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import mesh_dims
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              shard_train_state)
    from repro_torch.utils.tree import tree_count

    rank = dist.get_rank()
    dev = (torch.device("cpu") if mesh.device_type == "cpu" else
           torch.device("cuda", torch.cuda.current_device()))
    cfg = cfg_override or (configs.get_smoke(args.arch) if args.smoke
                           else configs.get(args.arch))
    mode = args.sharding
    tp = getattr(args, "tp", None) or tp_size(mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, tp=tp, device=dev)
    n_params = tree_count(params)
    state = shard_train_state(init_train_state(params), mesh, mode)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        print(f"arch={cfg.name} params={n_params / 1e6:.1f}M mesh="
              f"{mesh_dims(mesh)} "
              f"sharding={mode} backend={dist.get_backend()} tp={tp} "
              f"device={dev}", flush=True)
    loss_fn = lm.make_loss_fn(cfg, remat=getattr(args, "remat", True),
                              xent_chunk=512)
    step_fn = make_train_step(
        loss_fn, lambda s: cosine_schedule(s, peak_lr=args.lr, warmup=20,
                                           total=args.steps),
        accum=args.accum, mesh=mesh, mode=mode)
    batches = synthetic_batches(cfg, args.batch, args.seq, args.seed)
    tokens = args.batch * args.seq
    rows, t_all = [], 0.0
    for i in range(args.steps):
        batch = to_tensors(next(batches), dev)
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        row = {"step": i, "loss": float(metrics["loss"]),
               "lr": float(metrics["lr"]),
               "grad_norm": float(metrics["grad_norm"]),
               "reduce_s": metrics["reduce_s"]}
        _sync(dev)
        row["s"] = time.perf_counter() - t0
        row["tokens_per_s"] = tokens / row["s"]
        rows.append(row)
        t_all += row["s"]
        if rank == 0 and (i % args.log_every == 0 or i == args.steps - 1):
            print(f"step {i:5d} loss {row['loss']:.4f} lr {row['lr']:.2e} "
                  f"gnorm {row['grad_norm']:.3f} global tok/s "
                  f"{tokens * len(rows) / t_all:.0f} grad reduction "
                  f"{row['reduce_s']:.3f} s", flush=True)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    if rank == 0 and peak is not None:
        print("peak memory a rank (GiB): "
              f"{[round(p, 2) for p in peaks]}", flush=True)
    return {"cfg": cfg, "state": state, "rows": rows, "start": 0,
            "peak_gib": peaks, "backend": dist.get_backend(), "tp": tp,
            "mesh": mesh_dims(mesh), "sharding": mode}


def fit_potential(args, generator, device, dtype):
    """The synthetic dataset and the Adam fit of train_md: returns
    (spec, params, dataset, loss history)."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.core.training import fit_adam, generate_dataset
    from repro_torch.md.lattice import b20_fege

    oracle = HeisenbergDMIModel(r0=2.45, morse_de=0.4, morse_alpha=1.6,
                                d0=args.d_over_j * 0.0166)
    spec = NEPSpinSpec(l_max=2, n_ang=2, n_rad=4, n_spin=3, basis_size=6)
    ds = generate_dataset(oracle, b20_fege(), (2, 2, 2), 24, generator,
                          dtype=dtype, device=device)
    params, hist = fit_adam(spec, ds, generator, steps=args.fit_steps)
    return spec, params, ds, hist


def train_md(args, *, keep: dict | None = None) -> dict:
    """Fit, then MD with the fitted weights (the reference's ``train_md``);
    returns the fit's RMSEs and losses and the run's per-chunk numbers.
    ``keep`` (a dict) receives the ``Simulation`` under ``"sim"``."""
    from repro_torch.core.potential import NEPSpinPotential
    from repro_torch.core.training import rmse_metrics
    from repro_torch.md.analysis import helix_pitch, topological_charge
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.simulate import Simulation
    from repro_torch.md.state import init_state, temperature_of

    dev = resolve_device(args.device)
    dtype = torch.float32
    use_kernel = (dev.type == "cuda") if args.use_kernel is None \
        else args.use_kernel
    g = torch.Generator(device=dev).manual_seed(args.seed)
    lat = b20_fege()

    print("generating synthetic constrained-DFT data + fitting NEP-SPIN...")
    t0 = time.perf_counter()
    spec, params, ds, hist = fit_potential(args, g, dev, dtype)
    fit_s = time.perf_counter() - t0
    fit = rmse_metrics(spec, params, ds)
    print("fit:", fit)

    st = init_state(lat, (args.cells,) * 3, generator=g,
                    temperature=args.temperature, spin_init="helix_x",
                    dtype=dtype, device=dev)
    masses = torch.tensor(lat.masses, dtype=dtype, device=dev)
    moments = torch.tensor(lat.moments, dtype=dtype, device=dev)
    icfg = IntegratorConfig(dt=2e-3, temperature=args.temperature,
                            lattice_gamma=2.0, spin_alpha=0.05,
                            spin_longitudinal=0.05)
    sim = Simulation(
        potential=NEPSpinPotential(spec, params, moments,
                                   use_kernel=use_kernel),
        cfg=icfg, state=st, masses=masses, magnetic=moments > 0,
        cutoff=spec.cutoff, capacity=64, use_cell_list=True,
        cell_capacity=32,
        field=torch.tensor([0.0, 0.0, args.field], dtype=dtype, device=dev),
        device=dev)
    if keep is not None:
        keep["sim"] = sim
    temps = []

    def per_chunk(state, ff):
        temps.append(float(temperature_of(state, masses)))

    rows = []
    md_s = 0.0
    for block in range(args.steps // 50):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(50, g, chunk=25, callback=per_chunk)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        md_s += time.perf_counter() - t0
        q = float(topological_charge(sim.state.pos, sim.state.spin,
                                     sim.state.box))
        rows.append({"step": (block + 1) * 50, "energy": sim.energy,
                     "temperature": temps[-1], "charge": q})
        print(f"step {(block + 1) * 50:5d} E {sim.energy:10.4f} "
              f"T {temps[-1]:6.1f}K Q {q:+.2f}  ({md_s:.1f}s)")
    pitch = float(helix_pitch(sim.state.pos, sim.state.spin, sim.state.box))
    print(f"pitch: {pitch:.1f} A")
    steps = 50 * (args.steps // 50)
    return {"spec": spec, "fit": fit, "loss_first": hist[0],
            "loss_last": hist[-1], "fit_s": fit_s,
            "n_atoms": int(st.pos.shape[0]), "use_kernel": use_kernel,
            "steps": steps, "md_s": md_s,
            "steps_per_s": steps / md_s if md_s > 0 else None,
            "chunk_temperatures": temps, "rows": rows, "pitch": pitch,
            "rebuilds": sim.n_rebuilds}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    # LM options (the reference's defaults)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=2 or data=2,model=2 (pod/data/model)")
    ap.add_argument("--sharding", default="tp", choices=("tp", "fsdp", "dp"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl with a card a rank, else gloo")
    ap.add_argument("--tp", type=int, default=None,
                    help="build the parameters at this tp (default: the "
                    "mesh's model size, else 1)")
    # MD options (the reference's defaults)
    ap.add_argument("--cells", type=int, default=6)
    ap.add_argument("--temperature", type=float, default=160.0)
    ap.add_argument("--field", type=float, default=0.1)
    ap.add_argument("--d-over-j", type=float, default=0.3)
    ap.add_argument("--fit-steps", type=int, default=150)
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=None, help="MD through K1/K2 (default: on a "
                    "CUDA device)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.arch == MD_ARCH:
        return train_md(args)
    return train_lm(args)


if __name__ == "__main__":
    main()
