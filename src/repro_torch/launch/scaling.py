#!/usr/bin/env python3
"""Weak scaling of the Sharded fused MD loop, the paper's Fig. 7/8 and
Table V (port of ``benchmarks/scaling.py``).

    PYTHONPATH=src python -m repro_torch.launch.scaling [--smoke]
        [--device cuda|cpu] [--out DIR]

:class:`~repro_torch.md.simulate.SimulationSharded` (Heisenberg-DMI, simple
cubic, f32, chunk 80, cutoff 5.0, skin 0.3, capacity 8) with a fixed
subdomain a rank: ``floor`` 4^3 and ``bulk`` 8^3 sites a rank, the x extent
growing with the ranks.  Each rank count runs in its own world of ranks
(``parallel/ranks.py:spawn``; the reference forces host devices instead);
one warm chunk, then 3 chunks timed (one under ``--smoke``).  A rank on the
CPU computes on one thread.  Per run: steps/s, rebuilds and migrations,
halo exchanges and bytes by tag over the timed steps, and the kernel
builds and library loads during them
(:class:`~repro_torch.telemetry.CompileWatchdog`, the reference's
``compiles_during_run``), which must be 0.  The 1-rank run also times the
flat :class:`~repro_torch.md.simulate.Simulation`.  The reference's drift
invariant is asserted in every rank: exactly one ``drift-pos`` exchange a
step.

Efficiency: ``weak_efficiency_raw`` = steps/s(n) / steps/s(1 rank,
sharded); on the CPU ``weak_efficiency`` divides by the reference's
``min(1, cores / n)`` too (ranks share the host's cores).  The gate
(full runs): ``weak_efficiency >= 0.5`` at the largest n that fits the
host's cores, with gloo on the CPU, or at the largest n <= the card count
with NCCL.  Gloo ranks sharing one card measure no scaling: their raw
figure is the orchestration floor (the reference's meaning for simulated
devices), labelled so and not gated.

Backends (:func:`backend_for`): gloo on the CPU; on the card NCCL while n
<= the card count, else gloo ranks sharing the cards.  Rank counts: 1, 2,
4 and 8 on the CPU, 2 under ``--smoke``; on the card 1, 2 and 4.

Full runs also record the ``nep_kernel`` entry: NEP-SPIN through K1 / K2
and the q_Fp halo on 2 ranks (``launch/md_step.py:run_engine_chunk``),
asserting one drift-pos a step, at least one ``qfp`` round, no ``adjoint``
fold and no build or load in the timed steps.  Writes ``scaling.json``
under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch.launch import bench_common as bc

CPU_RANKS = (1, 2, 4, 8)
SMOKE_RANKS = (2,)
CARD_RANKS = (1, 2, 4)
SIZES = {"floor": (4, 4, 4), "bulk": (8, 8, 8)}     # 64 / 512 sites a rank
CHUNK = 80
CUTOFF, SKIN, CAPACITY = 5.0, 0.3, 8
KERNEL_RANKS, KERNEL_CHUNK, KERNEL_STEPS = 2, 5, 10
GATE = 0.5


# ---------------------------------------------------------------------------
# in each rank
# ---------------------------------------------------------------------------

def _device(job: dict):
    from repro_torch.utils.device import resolve_device
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    return resolve_device(job["device"])


def _timed(sim, steps: int, dev) -> dict:
    """One warm chunk, then ``steps`` timed: wall s, builds + loads and the
    halo ledger's gain over the timed steps."""
    from repro_torch.telemetry import CompileWatchdog
    gen = torch.Generator(device=dev)
    sim.run(CHUNK, gen.manual_seed(1), chunk=CHUNK)
    bc.sync(dev)
    ledger = getattr(sim, "halo_ledger", None)
    before = ledger.snapshot() if ledger is not None else None
    dog = CompileWatchdog()
    mark = dog.mark()
    t0 = time.perf_counter()
    sim.run(steps, gen.manual_seed(2), chunk=CHUNK)
    bc.sync(dev)
    out = {"wall_s": time.perf_counter() - t0,
           "compiles_during_run": dog.since(mark)}
    if ledger is not None:
        after = ledger.snapshot()
        counts = {t: after["counts"][t] - before["counts"].get(t, 0)
                  for t in after["counts"]}
        nbytes = {t: after["bytes"][t] - before["bytes"].get(t, 0)
                  for t in after["bytes"]}
        out.update(halo_counts=counts, halo_bytes=nbytes,
                   halo_bytes_per_step=after["bytes_per_step"])
    return out


def _measure(job: dict, size: str, dev) -> dict:
    import torch.distributed as dist

    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.simulate import Simulation, SimulationSharded
    from repro_torch.md.state import init_state
    n = job["ranks"]
    steps = CHUNK if job["smoke"] else 3 * CHUNK
    lat = simple_cubic()
    per = SIZES[size]
    st = init_state(lat, (per[0] * n,) + per[1:], temperature=300.0,
                    spin_init="helix_x", generator=torch.Generator(
                        device=dev).manual_seed(0), device=dev)
    kw = dict(potential=HeisenbergDMIModel(d0=0.01),
              cfg=IntegratorConfig(dt=2e-3), state=st,
              masses=torch.tensor(lat.masses, dtype=torch.float32,
                                  device=dev),
              magnetic=torch.tensor(lat.moments, device=dev) > 0,
              cutoff=CUTOFF, capacity=CAPACITY, skin=SKIN, device=dev)
    atoms = int(st.pos.shape[0])
    out = {"ranks": n, "size": size, "atoms": atoms,
           "atoms_per_rank": atoms // n, "steps": steps,
           "backend": dist.get_backend()}
    if n == 1:
        flat = _timed(Simulation(**kw), steps, dev)
        out["flat_steps_per_s"] = steps / flat["wall_s"]
    sh = SimulationSharded(**kw)
    t = _timed(sh, steps, dev)
    drift = t["halo_counts"].get("drift-pos", 0)
    # the drift-exchange invariant: one position halo a step
    if drift != steps:
        raise AssertionError(f"{drift} drift-pos exchanges in {steps} steps: "
                             f"{t['halo_counts']}")
    out.update(t, steps_per_s=steps / t["wall_s"], rebuilds=sh.n_rebuilds,
               migrated=sh.n_migrated, cells=list(sh._dspec.cells),
               cell_capacity=int(sh._dspec.capacity),
               drift_pos_exchanges_per_step=drift / steps)
    return out


def _rank_main(rank: int, job: dict, out: str) -> None:
    dev = _device(job)
    res = {size: _measure(job, size, dev) for size in job["sizes"]}
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


def _kernel_rank(rank: int, job: dict, out: str) -> None:
    from repro_torch.launch.md_step import run_engine_chunk
    dev = _device(job)
    # y/z need >= 3 cells at cutoff+skin reach; x grows with the ranks
    res = run_engine_chunk(cells=(4 * job["ranks"], 6, 6),
                           steps=KERNEL_STEPS, chunk=KERNEL_CHUNK,
                           kernel=True, device=str(dev))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)


# ---------------------------------------------------------------------------
# the parent: one world of ranks per rank count
# ---------------------------------------------------------------------------

def backend_for(n: int, device_type: str) -> str:
    """gloo on the CPU; on the card NCCL while n <= the card count."""
    if device_type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _world(fn, n: int, job: dict, backend: str) -> dict:
    from repro_torch.parallel.ranks import spawn
    with tempfile.TemporaryDirectory(prefix="scaling-") as d:
        out = os.path.join(d, "rank0.json")
        spawn(fn, n, job, out, backend=backend, workdir=d)
        with open(out) as f:
            return json.load(f)


def kernel_entry(dev) -> dict:
    """The NEP kernel route through the Sharded loop on 2 ranks, with its
    contract checked."""
    be = backend_for(KERNEL_RANKS, dev.type)
    job = {"ranks": KERNEL_RANKS, "device": dev.type}
    res = _world(_kernel_rank, KERNEL_RANKS, job, be)
    counts = res.pop("halo_counts")
    res.pop("halo_bytes")
    total = KERNEL_STEPS + KERNEL_CHUNK           # the warm chunk too
    out = {**res, "steps": KERNEL_STEPS, "chunk": KERNEL_CHUNK,
           "backend": be, "halo_counts": counts,
           "drift_pos_exchanges_per_step": counts.get("drift-pos", 0) / total,
           "qfp_exchanges": counts.get("qfp", 0)}
    # the kernel route's contract: one position halo a drift, the adjoint
    # accumulators through the q_Fp exchange, no reaction fold
    if (out["drift_pos_exchanges_per_step"] != 1 or out["qfp_exchanges"] < 1
            or "adjoint" in counts or out["compiles_during_run"]):
        raise AssertionError(f"nep_kernel entry breaks its contract: {out}")
    return out


def run(device="cuda") -> dict:
    from repro_torch.utils.device import resolve_device
    dev = resolve_device(device)
    smoke = bc.smoke()
    ranks = (SMOKE_RANKS if smoke else
             CARD_RANKS if dev.type == "cuda" else CPU_RANKS)
    sizes = ("floor",) if smoke else tuple(SIZES)
    cores = os.cpu_count() or 1
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    out = {"smoke": smoke, "device": str(dev), "potential": "heisenberg",
           "chunk": CHUNK, "skin": SKIN, "capacity": CAPACITY,
           "host_cores": cores, "cards": n_cards,
           "efficiency_definition": (
               "weak_efficiency_raw = steps/s(n) / steps/s(1 rank, "
               "sharded); on the CPU weak_efficiency = steps/s(n) / "
               "(steps/s(1) * min(1, host_cores / n)), ranks sharing the "
               "host's cores; NCCL ranks on their own cards: "
               "weak_efficiency = raw; gloo ranks sharing a card: the raw "
               "figure is the orchestration floor, not gated"),
           "sizes": {s: {"atoms_per_rank": 0, "sharded": {}}
                     for s in sizes}}
    for n in ranks:
        be = backend_for(n, dev.type)
        job = {"ranks": n, "device": dev.type, "smoke": smoke,
               "sizes": sizes}
        res = _world(_rank_main, n, job, be)
        for size, r in res.items():
            r["shared_card"] = dev.type == "cuda" and n > n_cards
            entry = out["sizes"][size]
            entry["atoms_per_rank"] = r["atoms_per_rank"]
            if "flat_steps_per_s" in r:
                entry["flat_1rank_steps_per_s"] = r["flat_steps_per_s"]
            entry["sharded"][str(n)] = r
    rows = []
    for size in sizes:
        entry = out["sizes"][size]
        base = entry["sharded"].get("1", {}).get("steps_per_s")
        for n_s, r in entry["sharded"].items():
            n = int(n_s)
            if base:
                r["weak_efficiency_raw"] = r["steps_per_s"] / base
                if dev.type == "cpu":
                    r["weak_efficiency"] = r["steps_per_s"] / (
                        base * min(1.0, cores / n))
                elif not r["shared_card"]:
                    r["weak_efficiency"] = r["weak_efficiency_raw"]
                else:
                    r["orchestration_floor"] = r["weak_efficiency_raw"]
            eff = r.get("weak_efficiency", r.get("orchestration_floor"))
            label = "floor-raw" if "orchestration_floor" in r else "eff"
            if r["compiles_during_run"]:
                raise AssertionError(f"kernel builds or loads during the "
                                     f"timed run: {r}")
            rows.append(bc.row(
                f"scaling/{size}/sharded/ranks={n}/N={r['atoms']}",
                1e6 / r["steps_per_s"],
                f"{r['steps_per_s']:.1f} steps/s|{r['backend']}|"
                + (f"{label}={eff * 100:.1f}%|" if eff is not None else "")
                + f"{r['rebuilds']} rebuilds|{r['compiles_during_run']} "
                f"builds|halo={r['halo_bytes_per_step']}B/step"))
        flat = entry.get("flat_1rank_steps_per_s")
        if flat:
            rows.append(bc.row(f"scaling/{size}/baseline/flat-fused/ranks=1",
                               1e6 / flat, f"{flat:.1f} steps/s"))
    if not smoke:
        k = kernel_entry(dev)
        out["nep_kernel"] = k
        rows.append(bc.row(
            f"scaling/nep_kernel/sharded/ranks={k['ranks']}/N={k['atoms']}",
            1e6 / k["steps_per_s"],
            f"{k['steps_per_s']:.2f} steps/s|{k['backend']}|"
            f"{k['compiles_during_run']} builds|qfp={k['qfp_exchanges']}"))
        # NCCL ranks on a card each: backend_for's n <= the card count
        gated = [n for n in ranks
                 if 1 < n <= (cores if dev.type == "cpu" else n_cards)]
        gate_n = max(gated, default=None)
        out["efficiency_gate"] = {"ranks": gate_n, "min": GATE,
                                  "size": "floor"}
        if gate_n is not None and "floor" in sizes:
            r = out["sizes"]["floor"]["sharded"][str(gate_n)]
            if not r.get("weak_efficiency", 0.0) >= GATE:
                raise AssertionError(f"weak efficiency below {GATE} at "
                                     f"{gate_n} ranks: {r}")
    out["rows"] = rows
    return out


def main(argv=None) -> dict:
    ap = bc.add_args(argparse.ArgumentParser(
        description=__doc__.splitlines()[0]))
    args = bc.parse(ap, argv)
    with bc.switches(args):
        out = run(args.device)
    bc.write_json(args.out / "scaling.json", out)
    return out


if __name__ == "__main__":
    main()
