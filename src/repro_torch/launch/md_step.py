"""One field-cooled chunk of the Engine on the Sharded plan, on one or more
ranks (port of ``repro.launch.md_step``'s engine half).

    PYTHONPATH=src python -m repro_torch.launch.md_step [--cells 8 6 6]
        [--steps 40] [--chunk 20] [--kernel] [--nproc 2] [--backend gloo]
        [--halo-mode auto] [--check-flat] [--device cuda] [--out res.json]

Simple cubic ``--cells`` under ``protocol.field_cooling`` (160 K -> 40 K,
0.1 T) through ``Engine(plan=Sharded())``: Heisenberg-DMI, or with
``--kernel`` NEP-SPIN at the smoke spec through K1/K2 and the q_Fp halo.
One warm chunk, then ``--steps`` timed.  ``--nproc`` ranks are spawned with
``torch.multiprocessing`` and meet at a ``file://`` rendezvous
(``--backend``: ``nccl`` puts rank r on card r, ``gloo`` may share one
card, in allgather mode, with its messages through the host - no scaling
figure; ``--halo-mode`` as ``Sharded.halo_mode``).  Rank 0 prints the
steps/s, rebuilds, migrations, the halo ledger and the charge trace, then
one JSON line.  ``--check-flat`` runs f64 NVE instead (no thermostat, no schedule)
and rank 0 then runs the flat Engine from the same state for as many
steps: ``vs_flat`` is the largest |difference| of pos, vel and spin.
``--out`` also writes rank 0's result to a JSON file, which a caller reads
instead of the ranks' shared standard output.

The dry-run half (:func:`build_md_dryrun`, which ``launch/dryrun.py``
drives) counts one integrator step of the fege-spinlattice cell on one
rank's slab of fake tensors inside a fake process group of the mesh's
world size: FLOPs and bytes by :mod:`repro_torch.utils.cost`, collectives
by the halo ledger, memory from the shapes and the live fake tensors.
Nothing is allocated on a device.
"""
from __future__ import annotations

import argparse
import json
import time

# per-rank cell grids (the paper's weak-scaling analogue: small and large)
MD_SHAPES = {
    "md_small": (8, 8, 8),      # ~0.13M atoms a card, 67M on 512 cards
    "md_large": (16, 16, 16),   # ~1.05M atoms a card, 536M on 512 cards
}


def domain_for_mesh(mesh, cells_per_device, cell_size):
    """The global domain of ``cells_per_device`` cells on every rank of
    ``mesh``: mesh dimensions onto space as data -> X, model -> Y,
    pod -> Z (capacity 16, cutoff 5.0, skin 0)."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.parallel.domain import DomainSpec
    shape = mesh_shape(mesh)
    axis_map = ("data", "model", "pod" if "pod" in shape else None)
    grid = [shape.get(a, 1) if a else 1 for a in axis_map]
    cells = tuple(c * g for c, g in zip(cells_per_device, grid))
    box = tuple(c * cell_size for c in cells)
    return DomainSpec(cells=cells, capacity=16, cutoff=5.0, box=box,
                      axis_map=axis_map)


def build_md_dryrun(shape_name: str, mesh, dtype=None,
                    temperature: float = 160.0, midpoint: bool = False,
                    impl: str = "stencil", nbr_capacity: int = 64) -> dict:
    """Count one step of the MD cell on this rank; returns the record's
    meta.

    The step is the reference's: Langevin lattice and sLLG spin
    thermostats at ``temperature``, a 0.1 T field along z, moments 1.16 /
    0.0 (Fe / Ge), one force/field evaluation by ``impl``: ``"stencil"``
    (27-shift streaming) or ``"pruned"`` (the pre-staged top-M table, an
    INPUT of the step as in the reference: it is rebuilt on skin
    violations, and its build is data-dependent, which fake tensors cannot
    run).  It runs on fake tensors (``FakeTensorMode``) of this rank's slab
    inside the initialised (fake) world of ``mesh``; the meta holds the
    reference's atom counts, the op-cost triple and op counts
    (``op_cost``, ``ops``), the halo ledger (``ledger``) and the
    memory: argument and output bytes from the shapes, temp bytes the peak
    of live op outputs during the step."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.fege_spinlattice import config
    from repro_torch.core.potential import init_params
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.md.integrator import (ForceField, IntegratorConfig,
                                           make_fused_step)
    from repro_torch.md.state import SpinLatticeState
    from repro_torch.parallel.domain import (distributed_energy_fn,
                                             distributed_energy_fn_pruned)
    from repro_torch.parallel.halo import HaloTrace
    from repro_torch.utils import units
    from repro_torch.utils.cost import CostCounter
    from repro_torch.utils.tree import tree_bytes

    dtype = dtype or torch.float32
    mdcfg = config()
    spec = mdcfg.spec
    dspec = domain_for_mesh(mesh, MD_SHAPES[shape_name], mdcfg.cell_size)
    dspec.check()
    n_dev = int(mesh.mesh.numel())
    cx, cy, cz = dspec.local_shape(mesh_shape(mesh))
    k = dspec.capacity
    icfg = IntegratorConfig(
        dt=mdcfg.dt, moment=1.16, midpoint=midpoint, midpoint_iters=2,
        temperature=temperature, lattice_gamma=1.0, spin_alpha=0.01,
        spin_longitudinal=0.1)
    field = (0.0, 0.0, 0.1)                     # Fig. 9 field protocol

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        gen = torch.Generator().manual_seed(0)
        masses = torch.tensor([units.MASS_FE, units.MASS_GE], dtype=dtype)
        magnetic = torch.tensor([True, False])
        moments = torch.tensor([1.16, 0.0], dtype=dtype)
        params = init_params(spec, gen, dtype=dtype, device="cpu")
        cell = lambda *tail: torch.empty((cx, cy, cz, k) + tail, dtype=dtype)
        types = torch.zeros((cx, cy, cz, k), dtype=torch.int32)
        mask = torch.ones((cx, cy, cz, k), dtype=torch.bool)
        state = SpinLatticeState(
            pos=cell(3), vel=cell(3), spin=cell(3), types=types,
            box=torch.tensor(dspec.box, dtype=dtype))
        ff = ForceField(energy=torch.zeros((), dtype=dtype), force=cell(3),
                        field=cell(3))
        inputs = [params, state[:4], mask, ff]
        if impl == "pruned":
            _, effn = distributed_energy_fn_pruned(
                spec, dspec, mesh, capacity=nbr_capacity, field=field,
                moments=moments)
            tbl = (torch.zeros((cx, cy, cz, k, nbr_capacity),
                               dtype=torch.int32),
                   torch.ones((cx, cy, cz, k, nbr_capacity),
                              dtype=torch.bool))
            inputs.append(tbl)

            def evaluate(pos, spin, types):
                return effn(params, pos, spin, types, mask, *tbl)
        elif impl == "stencil":
            _, effn = distributed_energy_fn(spec, dspec, mesh, field=field,
                                            moments=moments)

            def evaluate(pos, spin, types):
                return effn.raw(params, pos, spin, types, mask)
        else:
            raise ValueError(f"impl {impl!r}: 'stencil' or 'pruned'")
        step = make_fused_step(
            gather=lambda pos, _nbh: pos,
            compute=lambda pos, spin, types, _field: ForceField(*evaluate(
                pos, spin, torch.clamp(types, min=0))),
            cfg=icfg, masses=masses, magnetic=magnetic,
            atom_mask="from_types")
        with CostCounter() as counter, HaloTrace() as ledger:
            new_state, new_ff, _ = step(state, ff, state.pos, gen)
            out_bytes = tree_bytes([new_state[:4], new_ff])
        del new_state, new_ff

    n_atoms = dspec.cells[0] * dspec.cells[1] * dspec.cells[2] * 13
    rec = counter.record()
    return {"kind": "md", "tokens": n_atoms, "atoms": n_atoms,
            "atoms_per_device": n_atoms // n_dev,
            "cells": tuple(dspec.cells), "local_cells": (cx, cy, cz),
            "capacity": k, "impl": impl, "dtype": str(dtype).split(".")[-1],
            "op_cost": {key: rec[key] for key in
                        ("flops", "bytes_naive", "bytes_anchor")},
            "ops": rec["ops"],
            "ledger": ledger.snapshot(),
            "memory": {"argument_bytes": tree_bytes(inputs),
                       "output_bytes": out_bytes,
                       "temp_bytes": rec["peak_bytes"]}}


def run_engine_chunk(cells=(8, 6, 6), steps: int = 40, chunk: int = 20,
                     temperature: float = 160.0, kernel: bool = False,
                     seed: int = 0, device: str = "cuda",
                     halo_mode: str = "auto",
                     check_flat: bool = False) -> dict:
    """Drive one warm chunk and ``steps`` timed steps of the Engine on the
    Sharded plan over the initialised world (or one rank without a process
    group); returns {steps_per_s, rebuilds, migrated, halo ledger, kernel
    builds and library loads during the timed steps, ...}."""
    import torch

    from repro_torch.configs.fege_spinlattice import config, smoke_config
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.core.potential import NEPSpinPotential, init_params
    from repro_torch.ensemble import protocol
    from repro_torch.md.engine import Engine
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.state import init_state
    from repro_torch.parallel.plan import Sharded
    from repro_torch.telemetry import CompileWatchdog
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    dt = config().dt
    dtype = torch.float64 if check_flat else torch.float32
    lat = simple_cubic()
    g = torch.Generator(device=dev).manual_seed(seed)
    st = init_state(lat, tuple(cells), generator=g, temperature=temperature,
                    spin_init="helix_x", dtype=dtype, device=dev)
    if kernel:   # the smoke spec keeps the orchestration timing cheap
        spec = smoke_config().spec
        potential = NEPSpinPotential(
            spec, init_params(spec, g, dtype=dtype, device=dev),
            use_kernel=True)
    else:
        potential = HeisenbergDMIModel(d0=0.01)
    kw = dict(potential=potential, state=st,
              masses=torch.tensor(lat.masses, dtype=dtype, device=dev),
              magnetic=torch.tensor(lat.moments, device=dev) > 0,
              cutoff=5.0, capacity=16, skin=0.3,
              observables=("energy", "magnetization", "charge"), device=dev)
    if check_flat:
        kw["cfg"] = IntegratorConfig(dt=dt, moment=1.16)
    else:
        t_end = steps * dt
        temp, field = protocol.field_cooling(
            temperature, temperature / 4, 0.1, t_hold=0.2 * t_end,
            t_ramp=0.6 * t_end)
        kw.update(cfg=IntegratorConfig(dt=dt, moment=1.16, lattice_gamma=1.0,
                                       spin_alpha=0.01),
                  temperature=temp, field=field)
    eng = Engine(plan=Sharded(halo_mode=halo_mode), **kw)
    rank = eng._rplan.rank
    run_gen = torch.Generator(device=dev).manual_seed(1 + 1000 * rank)
    eng.run(chunk, run_gen, chunk=chunk)                  # warm
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    dog = CompileWatchdog()
    mark = dog.mark()
    t0 = time.perf_counter()
    eng.run(steps, run_gen, chunk=chunk)
    sync()
    wall = time.perf_counter() - t0
    compiles = dog.since(mark)
    vs_flat = None
    if check_flat and rank == 0:
        flat = Engine(**kw)
        flat.run(chunk + steps, chunk=chunk)
        vs_flat = max(float((getattr(flat.state, k)
                             - getattr(eng.state, k)).abs().max())
                      for k in ("pos", "vel", "spin"))
    ledger = eng.halo_ledger
    return {
        "ranks": eng._rplan.world, "atoms": int(st.pos.shape[0]),
        "cells": list(eng._rplan.dspec.cells),
        "cell_capacity": int(eng._rplan.dspec.capacity),
        "allgather": eng._rplan.allgather,
        "steps_per_s": steps / wall, "compiles_during_run": compiles,
        "rebuilds": eng.n_rebuilds,
        "migrated": eng.n_migrated, "vs_flat": vs_flat,
        "charge": [float(q) for q in eng.trace.values["charge"]],
        "halo_counts": dict(ledger.counts), "halo_bytes": dict(ledger.bytes),
        "halo_bytes_per_step": ledger.per_step_bytes(),
    }


def _rank_main(rank: int, kw: dict, out: str | None = None) -> None:
    res = run_engine_chunk(**kw)
    if rank == 0:
        _report(res, out)


def _report(res: dict, out: str | None = None) -> None:
    if out is not None:
        with open(out, "w") as f:
            json.dump(res, f)
    print(f"engine chunk on {res['ranks']} rank(s): {res['atoms']} atoms, "
          f"grid {res['cells']} x {res['cell_capacity']}, "
          f"{res['steps_per_s']:.1f} steps/s, {res['rebuilds']} rebuilds "
          f"({res['migrated']} migrations)")
    print(f"  halo ledger: {res['halo_counts']}")
    print(f"  Q trace: {[round(q, 2) for q in res['charge']]}")
    print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, nargs=3, default=(8, 6, 6))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--kernel", action="store_true",
                    help="NEP-SPIN through K1/K2 and the q_Fp halo")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks to spawn (1: this process, no group)")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--halo-mode", default="auto",
                    choices=("auto", "ppermute", "allgather"))
    ap.add_argument("--check-flat", action="store_true",
                    help="f64 NVE, checked on rank 0 against the flat "
                         "Engine")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="write rank 0's result JSON to this file too")
    args = ap.parse_args(argv)
    kw = dict(cells=tuple(args.cells), steps=args.steps, chunk=args.chunk,
              kernel=args.kernel, device=args.device,
              halo_mode=args.halo_mode, check_flat=args.check_flat)
    if args.nproc == 1:
        _report(run_engine_chunk(**kw), args.out)
        return 0
    from repro_torch.parallel.ranks import spawn
    spawn(_rank_main, args.nproc, kw, args.out, backend=args.backend)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
