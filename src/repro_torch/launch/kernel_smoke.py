"""Smoke run of the NEP kernels K1 and K2 (port of
``scripts/kernel_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.kernel_smoke [--device cpu]

On the reference's geometry and spec: B20 FeGe 4x4x4 at 300 K with random
spins, positions jittered by 0.08 A (seeded), ``NEPSpinSpec(l_max=2,
n_ang=2, n_rad=4, n_spin=2, basis_size=6)`` in f32, a dense neighbor table
at capacity 64 that must not overflow (K2's pair-symmetric force assumes a
whole list).

On a CUDA device (``--device cuda``, the default; no card raises):

* the call through ``kernels.nep.ops.nep_energy_forces_field`` launches K1
  and K2, not their plain versions, on the body the spec picks (``warp``
  when it is in ``kernels/nep/kernel.py:WARP_SPECS``, else ``thread``);
* E, F and H_eff lie within 1e-4, 2e-4 and 2e-4 (relative to the largest
  |value|) of the plain oracle: the same evaluation through
  ``kernels/nep/ref.py``'s ``atom_pass_plain`` / ``force_pass_plain``;
* the kernel path beats the plain version on the same card by more than
  1.2x (median of 3 rounds of 5 warm calls each), where the reference held
  its compiled executor against interpret mode;
* four chunked calls at fixed geometry build and load no kernel library
  (``_build.EVENTS``), the zero-recompile contract chunked drivers rely on.

On the CPU the wrappers take the plain versions: the smoke checks that no
kernel was launched and that the result is the oracle's, bitwise (there is
no faster path to time and nothing to build).  ``main`` returns a summary
dict and raises on any failure.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

SPEC_KW = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
CELLS = (4, 4, 4)
CAPACITY = 64
TOLS = {"E": 1e-4, "F": 2e-4, "H": 2e-4}
MIN_RATIO = 1.2


def setup(device):
    """(spec, params, pos, spin, types, table, box) of the smoke."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.potential import init_params
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.neighbor import dense_neighbor_table
    from repro_torch.md.state import init_state
    spec = NEPSpinSpec(**SPEC_KW)
    g = torch.Generator(device=device).manual_seed(0)
    st = init_state(b20_fege(), CELLS, generator=g, temperature=300.0,
                    spin_init="random", device=device)
    jit = torch.randn(st.pos.shape, generator=torch.Generator(
        device=device).manual_seed(9), device=device, dtype=st.pos.dtype)
    pos = st.pos + 0.08 * jit
    params = init_params(spec, torch.Generator(device=device).manual_seed(1),
                         dtype=torch.float32, device=device)
    tab = dense_neighbor_table(pos, st.box, spec.cutoff, CAPACITY)
    if int(tab.mask.sum(1).max()) >= CAPACITY:
        raise AssertionError("neighbor table overflow at capacity "
                             f"{CAPACITY}")
    return spec, params, pos, st.spin, st.types, tab, st.box


def plain_energy_forces_field(spec, params, pos, spin, types, table, box):
    """The oracle: ``ops.nep_energy_forces_field`` with K1 and K2 replaced
    by their plain versions (``kernels/nep/ref.py``)."""
    from repro_torch.kernels.nep import ref
    from repro_torch.md.neighbor import gather_blocks
    nbh = gather_blocks(pos, types, table, box)
    sj = spin[nbh.idx.long()]
    e, hdir, abar = ref.atom_pass_plain(spec, params, nbh.dr, nbh.mask,
                                        types, nbh.tj, spin, sj)
    force, h2 = ref.force_pass_plain(spec, params, nbh.dr, nbh.mask,
                                     nbh.idx, types, nbh.tj, spin, sj, abar)
    return torch.sum(e), force, hdir + h2


def _rel(got, want) -> float:
    return float((got - want).abs().max()
                 / (want.abs().max() + 1e-30))


def _launches():
    from repro_torch.kernels.nep import kernel
    return (kernel.nep_atom_pass.launches, kernel.nep_force_pass.launches,
            dict(kernel.nep_atom_pass.body_launches),
            dict(kernel.nep_force_pass.body_launches))


def med_time(fn, args, device) -> float:
    """Median over 3 rounds of the mean seconds of 5 warm calls."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    fn(*args)
    sync()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            fn(*args)
        sync()
        ts.append((time.perf_counter() - t0) / 5)
    return statistics.median(ts)


def main(argv=None) -> dict:
    from repro_torch import _build
    from repro_torch.kernels.nep import kernel
    from repro_torch.kernels.nep.ops import nep_energy_forces_field
    from repro_torch.utils.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    inputs = setup(dev)
    spec = inputs[0]
    bodies = {"K1": kernel.atom_pass_body(spec),
              "K2": kernel.force_pass_body(spec)}
    on_card = dev.type == "cuda"

    before = _launches()
    out = nep_energy_forces_field(*inputs)
    after = _launches()
    launched = (after[0] - before[0], after[1] - before[1])
    if on_card:
        if launched != (1, 1):
            raise AssertionError(f"K1/K2 launches {launched}, want (1, 1)")
        for name, b0, b1 in (("K1", before[2], after[2]),
                             ("K2", before[3], after[3])):
            if b1[bodies[name]] - b0[bodies[name]] != 1:
                raise AssertionError(f"{name} did not run its "
                                     f"{bodies[name]} body: {b0} -> {b1}")
    elif launched != (0, 0):
        raise AssertionError(f"CPU tensors launched kernels: {launched}")
    print(f"[kernel_smoke] {dev.type}: K1 {bodies['K1']} body, K2 "
          f"{bodies['K2']} body, launches {launched}")

    want = plain_energy_forces_field(*inputs)
    parity = {}
    for name, got, ref in zip(("E", "F", "H"), out, want):
        parity[name] = _rel(got, ref)
        if on_card:
            if not parity[name] < TOLS[name]:
                raise AssertionError(f"{name} parity: rel={parity[name]:.3e}"
                                     f" >= {TOLS[name]}")
        elif not torch.equal(got, ref):
            raise AssertionError(f"{name}: the CPU dispatch is not the "
                                 "plain version")
        print(f"[kernel_smoke] parity {name}: rel={parity[name]:.3e}")

    res = {"device": dev.type, "bodies": bodies, "launches": launched,
           "parity": parity, "ratio": None, "ms": None, "plain_ms": None,
           "builds": None}
    if on_card:
        t_kern = med_time(nep_energy_forces_field, inputs, dev)
        t_plain = med_time(plain_energy_forces_field, inputs, dev)
        ratio = t_plain / t_kern
        print(f"[kernel_smoke] kernels {t_kern * 1e3:.3f} ms/call, plain "
              f"{t_plain * 1e3:.3f} ms/call ({ratio:.2f}x)")
        if not ratio > MIN_RATIO:
            raise AssertionError(f"kernels only {ratio:.2f}x the plain "
                                 f"version (want > {MIN_RATIO}x)")
        ev0 = dict(_build.EVENTS)
        spec, params, pos, spin, types, tab, box = inputs
        for i in range(4):
            nep_energy_forces_field(spec, params, pos + 1e-4 * i, spin,
                                    types, tab, box)
        torch.cuda.synchronize(dev)
        new = {k: _build.EVENTS[k] - ev0[k] for k in ev0}
        if any(new.values()):
            raise AssertionError(f"chunked calls built or loaded kernels: "
                                 f"{new}")
        res.update(ratio=ratio, ms=t_kern * 1e3, plain_ms=t_plain * 1e3,
                   builds=new)
        print(f"[kernel_smoke] 4 chunked calls: {new} builds / loads")
    print(json.dumps({"kernel_smoke": res}))
    return res


if __name__ == "__main__":
    main()
