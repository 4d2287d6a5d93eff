"""Whether what the timed path produced is right: the plain reference
(:mod:`perfbench.reference`) worked out again from the benchmark's inputs
and held against the program's record (:mod:`perfbench.harness.program`).

Compared:

* the first evaluation, on the starting state;
* the first ``START_STEPS`` steps, the reference following its own
  trajectory from the starting state with the program's noise draws (each
  draw replayed from its generator's state and sent to the atom whose row
  or slot took it);
* one step after the window, from the state, the table's order and the
  carried evaluation the window left (the reference cannot rebuild the
  window's trajectory, so this step starts from the program's own state);
* (positions are not compared: float32 coordinates of up to 226 A carry
  1.5e-5 A in their last bit, half a percent of a step's displacement, so
  the comparison would read the rounding; a step's positions are judged
  through the forces and fields evaluated at them;)
* the window's last neighbor table, in atom ids (on the Sharded plan every
  rank's table, its slots mapped to atoms), against the reference's own
  search at the positions the window left.

The numbers (each the largest over the points):

* ``force_gap`` / ``field_gap``: the largest component gap of F or H over
  the largest root mean square component the reference gives (:class:`Gaps`);
* ``energy_gap``: the largest |E - E_ref| / |E_ref|;
* ``vel_gap``: the largest velocity gap over the reference's rms velocity;
* ``spin_gap``: the largest spin gap over the reference's rms spin turn in
  a step;
* ``pairs_missing``: pairs inside the cutoff the table does not list.
"""
from __future__ import annotations

import gc

import torch

from perfbench.harness import inputs
from perfbench.reference import integrator, neighbors

NUMBERS = ("force_gap", "field_gap", "energy_gap", "vel_gap", "spin_gap",
           "pairs_missing")
KEYS = ("k1", "k2", "k3", "k5")


class Reference:
    """The reference bound to a configuration's model, weights and
    crystal."""

    def __init__(self, config, model, inp, w, device, tf32: bool = False):
        self.evaluate = model.reference(config, w, inp, device, tf32=tf32)
        self.cutoff = config["potential"]["cutoff"]
        self.integ = config["integrator"]
        self.inp, self.dev = inp, device
        types = inp["types"]
        self.m = inp["masses"][types.long()][:, None]
        self.magnetic = inp["moments"][types.long()] > 0

    def noise(self, draws, n: int) -> dict:
        """The step's four normal draws (k1, k2, k3, k5) in atom order: each
        ``(generator state, row -> atom map or None)`` of ``draws`` drawn
        again, its rows sent to their atoms (-1: an empty slot)."""
        out = {k: torch.zeros((n, 3), device=self.dev) for k in KEYS}
        g = torch.Generator(device=self.dev)
        for state, amap in draws:
            g.set_state(state)
            rows = n if amap is None else amap.numel()
            for key in KEYS:
                z = torch.randn((rows, 3), generator=g, device=self.dev)
                if amap is None:
                    out[key] = z
                    continue
                amap = amap.to(self.dev).long()
                sel = amap >= 0
                out[key][amap[sel]] = z[sel]
        return out

    def step(self, pos, vel, spin, ff, noise):
        return integrator.step(pos, vel, spin, self.inp["box"], self.m,
                               self.magnetic, ff[1], ff[2], noise,
                               self.inp["temperature"], self.integ,
                               self.evaluate)


def _rms(x: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean(x.double() ** 2)))


def _maxabs(x: torch.Tensor) -> float:
    return float(torch.max(torch.abs(x.double()))) if x.numel() else 0.0


class Gaps:
    """The largest gap of each quantity over the points compared, and its
    scale: the largest root mean square the reference gives it at any
    point (the starting crystal is a minimum, where forces and fields are
    all but zero, so no single point's scale would do)."""

    def __init__(self):
        self.gap, self.scale, self.energy = {}, {}, 0.0

    def add(self, name: str, diff: torch.Tensor, ref: torch.Tensor):
        self.gap[name] = max(self.gap.get(name, 0.0), _maxabs(diff))
        self.scale[name] = max(self.scale.get(name, 0.0), _rms(ref))

    def ff(self, prog: dict, ff):
        e, f, h = (x.detach().cpu() for x in ff)
        self.energy = max(self.energy, abs(prog["energy"] - float(e))
                          / abs(float(e)))
        self.add("force", prog["force"] - f, f)
        self.add("field", prog["field"] - h, h)

    def state(self, prog: dict, before, after, magnetic):
        spin0 = before[2].cpu()
        vel, spin = after[1].cpu(), after[2].cpu()
        mag = magnetic.cpu()
        self.add("vel", prog["vel"] - vel, vel)
        self.add("spin", (prog["spin"] - spin)[mag], (spin - spin0)[mag])

    def numbers(self) -> dict:
        rel = {k: self.gap[k] / max(self.scale[k], 1e-30) for k in self.gap}
        return {"force_gap": rel["force"], "field_gap": rel["field"],
                "energy_gap": self.energy, "vel_gap": rel["vel"],
                "spin_gap": rel["spin"]}


def compare(config, model, traffic, cells, seed: int, rec: dict,
            device) -> dict:
    """The numbers of :data:`NUMBERS` for the program's record ``rec``."""
    w = model.weights(config, seed, device)
    inp = inputs.state(config, traffic, cells, seed, device)
    ref = Reference(config, model, inp, w, device)
    n = inp["pos"].shape[0]
    gaps = Gaps()
    st = (inp["pos"], inp["vel"], inp["spin"])
    ff = ref.evaluate(st[0], st[2])
    gaps.ff(rec["ff0"], ff)
    for point in rec["start"]:
        if point["rebuilt"]:
            ff = ref.evaluate(st[0], st[2])
        *new, ff = ref.step(*st, ff, ref.noise(point["draws"], n))
        gaps.ff(point["out"], ff)
        gaps.state(point["out"], st, new, ref.magnetic)
        st = tuple(new)
    pre, end = rec["pre"], rec["end"]
    st = tuple(pre[k].to(device) for k in ("pos", "vel", "spin"))
    if end["rebuilt"]:
        ff = ref.evaluate(st[0], st[2])
    else:
        ff = (None, pre["force"].to(device), pre["field"].to(device))
    *new, ff = ref.step(*st, ff, ref.noise(end["draws"], n))
    gaps.ff(end["out"], ff)
    gaps.state(end["out"], st, new, ref.magnetic)
    del ff, new
    gc.collect()
    missing = neighbors.missing_pairs(st[0], inp["box"], ref.cutoff,
                                      rec["table"]["idx"],
                                      rec["table"]["mask"])
    return {**gaps.numbers(), "pairs_missing": missing}


def control_record(config, model, traffic, cells, seed: int,
                   device) -> dict:
    """The control's record: the reference computed with TF32 contractions
    put in the program's place, on the same inputs, with noise drawn as a
    single card draws it, over the same points (its own trajectory stands
    in for the window's)."""
    w = model.weights(config, seed, device)
    inp = inputs.state(config, traffic, cells, seed, device)
    ctl = Reference(config, model, inp, w, device, tf32=True)
    gen = inputs.noise_generator(seed, 0, device)
    n = inp["pos"].shape[0]
    st = (inp["pos"], inp["vel"], inp["spin"])
    ff = ctl.evaluate(st[0], st[2])

    def snap():
        return {"pos": st[0].cpu(), "vel": st[1].cpu(), "spin": st[2].cpu(),
                "energy": float(ff[0]), "force": ff[1].cpu(),
                "field": ff[2].cpu()}

    def advance():
        nonlocal st, ff
        draws = [(gen.get_state(), None)]
        for _ in KEYS:
            torch.randn((n, 3), generator=gen, device=device)
        *new, ff = ctl.step(*st, ff, ctl.noise(draws, n))
        st = tuple(new)
        return {"draws": draws, "rebuilt": False, "out": snap()}

    rec = {"ff0": snap()}
    rec["start"] = [advance() for _ in range(2)]
    rec["pre"] = snap()
    idx, mask = neighbors.neighbor_list(
        st[0], inp["box"], ctl.cutoff + config["neighbor"]["skin_A"])
    rec["table"] = {"idx": idx.cpu(), "mask": mask.cpu()}
    rec["end"] = advance()
    return rec


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit)])``: every number at or below its
    limit (a number with no limit fails)."""
    rows = [(k, numbers[k], limits.get(k)) for k in NUMBERS]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows
