"""The system under test, driven as its users drive it: ``repro_torch``'s
``Engine`` on the mix's plan (:mod:`perfbench.plans`), its potential from
the configuration's model (:mod:`perfbench.models`), fed the inputs of
:mod:`perfbench.harness.inputs`.

Besides the window, the run keeps what the check compares, on the host of
rank 0: the first evaluation, the first ``START_STEPS`` steps and one step
after the window, each made by ``Engine.run`` on the engine the window
drives, with what the reference needs to replay that step's noise (each
generator's state before it, and the row or slot each atom's draw took).
"""
from __future__ import annotations

import time

import torch

from perfbench.harness import inputs

START_STEPS = 2


def build(config: dict, model, plan, w: dict, inp: dict, seed: int,
          rank: int, device):
    """``(engine, generator)``: the engine on the plan over the given
    inputs, and this rank's noise generator, which ``Engine.run`` takes."""
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.state import SpinLatticeState
    integ, nb = config["integrator"], config["neighbor"]
    cfg = IntegratorConfig(dt=integ["dt_ps"],
                           lattice_gamma=integ["lattice_gamma_per_ps"],
                           spin_alpha=integ["spin_alpha"],
                           moment=integ["moment_muB"])
    state = SpinLatticeState(inp["pos"], inp["vel"], inp["spin"],
                             inp["types"], inp["box"])
    eng = plan.engine(dict(
        potential=model.program(config, w, inp), cfg=cfg, state=state,
        masses=inp["masses"], magnetic=inp["moments"] > 0,
        cutoff=config["potential"]["cutoff"], temperature=inp["temperature"],
        field=list(config["field_T"]), capacity=nb["capacity"],
        skin=nb["skin_A"], use_cell_list=nb["use_cell_list"],
        cell_capacity=nb["cell_capacity"], device=device))
    return eng, inputs.noise_generator(seed, rank, device)


def snapshot(eng) -> dict:
    """The engine's state and its last evaluation, in input atom order, on
    the host."""
    ff = eng._ff
    host = lambda t: t.detach().to("cpu", copy=True)
    return {"pos": host(eng.state.pos), "vel": host(eng.state.vel),
            "spin": host(eng.state.spin),
            "energy": float(torch.as_tensor(ff.energy).reshape(())),
            "force": host(ff.force), "field": host(ff.field)}


def one_step(eng, gen, plan, group, keep: bool) -> dict:
    """One step through ``Engine.run`` and what the check needs of it
    (``keep``: this rank keeps the record)."""
    before = gen.get_state()
    n0 = eng.n_rebuilds
    eng.run(1, gen, chunk=1)
    draws = plan.draws(eng, before, group)
    return {"draws": draws, "rebuilt": eng.n_rebuilds > n0,
            "out": snapshot(eng) if keep else None}


def setup(config, traffic, model, plan, cells, seed, rank, group, device):
    """Inputs, engine and the start of the check: ``(engine, generator,
    record)``."""
    w = model.weights(config, seed, device)
    inp = inputs.state(config, traffic, cells, seed, device)
    eng, gen = build(config, model, plan, w, inp, seed, rank, device)
    del w, inp
    keep = rank == 0
    rec = {"ff0": snapshot(eng) if keep else None,
           "start": [one_step(eng, gen, plan, group, keep)
                     for _ in range(START_STEPS)]}
    return eng, gen, rec


def window(eng, gen, chunk: int, stop, device) -> dict:
    """``Engine.run`` chunk after chunk until ``stop(elapsed seconds)``,
    ending in a synchronize: steps, chunks, rebuilds and seconds."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    r0, steps, chunks = eng.n_rebuilds, 0, 0
    t0 = time.perf_counter()
    while True:
        eng.run(chunk, gen, chunk=chunk)
        steps += chunk
        chunks += 1
        if stop(time.perf_counter() - t0):
            break
    sync()
    return {"seconds": time.perf_counter() - t0, "steps": steps,
            "chunks": chunks, "rebuilds": eng.n_rebuilds - r0}


def finish(eng, gen, plan, group, rec: dict, keep: bool) -> None:
    """The step after the window, from the state the window left (its
    table and its carried evaluation with it)."""
    rec["pre"] = snapshot(eng) if keep else None
    rec["table"] = plan.table(eng, group)
    rec["end"] = one_step(eng, gen, plan, group, keep)
