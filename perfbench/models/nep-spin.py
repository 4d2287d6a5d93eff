"""The NEP-SPIN potential (a configuration whose ``potential.kind`` is
``nep-spin``): its weights from the seed, the program's potential
(``repro_torch``'s K1/K2 route), the plain reference's evaluation and one
evaluation's work.

The weights.  The radial, angular and magnetic coefficients are drawn as
the NEP-SPIN reference draws them (normal, 0.5, symmetric in the type
pair).  The network is drawn so that the crystal the benchmark starts from
is a minimum of the energy, as it is of a fitted potential: its hidden
units come in pairs that share a direction u in descriptor space, with
opposite input weights (``GAIN``), a common negative bias (drawn in
``BIAS``) and a common positive output weight (``SCALE``), centred on the
descriptor q0 of each type in the ideal crystal with its spins along +z,
so each pair adds an even function of u . (q - q0) with its minimum at q0;
u's magnetic share is ``SPIN_GAIN``.  With the network's weights drawn as
the reference's initialiser draws them, the crystal is no minimum: it heats
past 1,000 K within 200 fs, its neighbor tables fill to their capacity and
its throughput swings with the seed (``PERF.md``).
"""
from __future__ import annotations

import math

import torch

from perfbench.harness import inputs, work
from perfbench.reference import neighbors, nep_spin

KERNELS = ("nep_atom_pass", "nep_force_pass")
GAIN, SCALE, BIAS, SPIN_GAIN = 2.0, 10.0, (0.25, 0.75), 0.01
SPEC_KEYS = ("cutoff", "basis_size", "n_rad", "n_ang", "l_max", "n_spin",
             "n_onsite", "n_types", "hidden")


def weights(config: dict, seed: int, device) -> dict:
    """The network's weights (float32, on ``device``), by the rule of the
    module docstring."""
    spec = nep_spin.Spec.from_config(config["potential"])
    g = inputs.generator(seed, 1, device)
    t, k, h, d = spec.n_types, spec.basis_size, spec.hidden, spec.n_desc
    sizes = {"c_rad": spec.n_rad, "c_ang": spec.n_ang, "c_spin": spec.n_spin}
    raw = 0.5 * torch.randn((t, t, sum(sizes.values()), k), generator=g,
                            device=device)
    raw = 0.5 * (raw + raw.transpose(0, 1))
    w, lo = {}, 0
    for name, n in sizes.items():
        w[name] = raw[:, :, lo:lo + n].contiguous()
        lo += n
    w["q_scale"] = torch.ones(d, device=device)
    # the ideal crystal's descriptor per type, spins along +z
    moments = torch.tensor(config["lattice"]["moments_muB"], device=device)
    pos, types, box = inputs.crystal(config["lattice"], (4, 4, 4), device)
    idx, mask = neighbors.neighbor_list(pos, box, spec.cutoff)
    spin = inputs.ferro(types, moments)
    dr = neighbors.min_image(pos[idx] - pos[:, None, :], box)
    dr = torch.where(mask[..., None], dr, torch.full_like(dr, 2 * spec.cutoff))
    q = nep_spin.descriptor(spec, w, dr, mask, types, types[idx], spin,
                            spin[idx], nep_spin.Contract())
    q0 = torch.stack([q[types == a].mean(0) for a in range(t)])   # (T, D)
    half = h // 2
    draw = torch.rand((3, t, half), generator=g, device=device)
    u = torch.randn((t, d, half), generator=g, device=device) / math.sqrt(d)
    # the pseudo-dipolar and W.V channels read the spins' direction against
    # the bonds', which differs between the sites of one type in a crystal
    # magnetised along z; the pairs leave them out, so q0 is every site's
    lo = spec.n_rad + spec.n_ang * spec.l_max + spec.n_onsite
    u[:, lo + 2 * spec.n_spin:lo + 3 * spec.n_spin] = 0.0
    u[:, lo + 5 * spec.n_spin:lo + 6 * spec.n_spin] = 0.0
    u[:, lo:] *= SPIN_GAIN
    bias = -(BIAS[0] + (BIAS[1] - BIAS[0]) * draw[0])
    beta = SCALE * (0.5 + draw[1]) / h
    z0 = torch.einsum("td,tdp->tp", q0, u)
    w["w1"] = torch.cat([GAIN * u, -GAIN * u], dim=-1).contiguous()
    w["b1"] = torch.cat([bias - GAIN * z0, bias + GAIN * z0],
                        dim=-1).contiguous()
    w["w2"] = torch.cat([beta, beta], dim=-1).contiguous()
    w["b2"] = torch.zeros(t, device=device)
    return w


def program(config: dict, w: dict, inp: dict):
    """The program's potential on these weights: ``NEPSpinPotential``
    through K1/K2 (their plain versions on the CPU)."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.potential import NEPSpinParams, NEPSpinPotential
    pot = config["potential"]
    spec = NEPSpinSpec(**{k: pot[k] for k in SPEC_KEYS}, spin=True)
    params = NEPSpinParams(*(w[k] for k in NEPSpinParams._fields))
    return NEPSpinPotential(spec, params, inp["moments"], use_kernel=True)


def reference(config: dict, w: dict, inp: dict, device, tf32: bool = False):
    """``evaluate(pos, spin) -> (E, F, H)`` of the plain reference, with its
    own neighbor search (contractions in TF32 for the control)."""
    spec = nep_spin.Spec.from_config(config["potential"])
    mm = nep_spin.Contract(tf32=tf32)
    field = torch.tensor(config["field_T"], dtype=torch.float32,
                         device=device)

    def evaluate(pos, spin):
        idx, mask = neighbors.neighbor_list(pos, inp["box"], spec.cutoff)
        return nep_spin.evaluate(spec, w, pos, spin, inp["types"],
                                 inp["box"], idx, mask, inp["moments"],
                                 field, mm)
    return evaluate


def work_of(config: dict, n_atoms: int, n_pairs: int) -> dict:
    """One evaluation's operations, bytes and least time
    (:func:`perfbench.harness.work.evaluation`)."""
    return work.evaluation(config["potential"], n_atoms, n_pairs)
