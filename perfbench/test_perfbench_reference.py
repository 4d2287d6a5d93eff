"""The plain reference (perfbench/reference) against the port's plain
autograd path on a tiny float64 box: the same energy, forces and fields.
The test may import both; the reference imports nothing of the port."""
import json
from pathlib import Path

import pytest
import torch

from perfbench.harness import inputs, manifest
from perfbench.reference import neighbors, nep_spin

ROOT = Path(__file__).resolve().parents[1]


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["nep-spin-prod", "nep-spin-small"])
def test_reference_matches_the_port_plain_path(name):
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.potential import (NEPSpinParams,
                                            energy_forces_field)
    from repro_torch.md.neighbor import dense_neighbor_table
    cfg = _config(name)
    dev = torch.device("cpu")
    w = {k: v.double() for k, v in manifest.model(cfg).weights(
        cfg, 3, dev).items()}
    pos, types, box = inputs.crystal(cfg["lattice"], (3, 3, 3), dev)
    g = torch.Generator().manual_seed(4)
    pos = torch.remainder(pos.double() + 0.1 * torch.randn(
        pos.shape, generator=g, dtype=torch.float64), box.double())
    box = box.double()
    moments = torch.tensor(cfg["lattice"]["moments_muB"],
                           dtype=torch.float64)
    spin = torch.nn.functional.normalize(torch.randn(
        pos.shape, generator=g, dtype=torch.float64), dim=-1)
    spin = spin * (moments[types.long()] > 0)[:, None]
    field = torch.tensor(cfg["field_T"], dtype=torch.float64)
    spec = nep_spin.Spec.from_config(cfg["potential"])
    idx, mask = neighbors.neighbor_list(pos, box, spec.cutoff)
    e, f, h = nep_spin.evaluate(spec, w, pos, spin, types, box, idx, mask,
                                moments, field, nep_spin.Contract())
    pspec = NEPSpinSpec(**{k: cfg["potential"][k] for k in (
        "cutoff", "basis_size", "n_rad", "n_ang", "l_max", "n_spin",
        "n_onsite", "n_types", "hidden")})
    params = NEPSpinParams(*(w[k] for k in NEPSpinParams._fields))
    table = dense_neighbor_table(pos, box, spec.cutoff, 96, skin=0.5)
    e2, f2, h2 = energy_forces_field(pspec, params, pos, spin, types, table,
                                     box, field, moments)
    assert float(abs(e - e2)) <= 1e-10 * abs(float(e2))
    assert float((f - f2).abs().max()) <= 1e-9 * float(f2.abs().max())
    assert float((h - h2).abs().max()) <= 1e-9 * float(h2.abs().max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -3.0], dtype=torch.float32)
    y = nep_spin.round_tf32(x)
    assert y.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2 * 2.0 ** -10, -3.0]


def test_neighbor_search_matches_all_pairs():
    g = torch.Generator().manual_seed(1)
    box = torch.tensor([17.0, 18.0, 19.0])
    pos = torch.rand((400, 3), generator=g) * box
    idx, mask = neighbors.neighbor_list(pos, box, 5.0, block=64)
    dr = neighbors.min_image(pos[None] - pos[:, None], box)
    d2 = (dr * dr).sum(-1)
    want = (d2 < 25.0) & ~torch.eye(400, dtype=torch.bool)
    got = torch.zeros_like(want)
    rows = torch.arange(400)[:, None].expand_as(idx)
    got[rows[mask], idx[mask]] = True
    assert torch.equal(got, want)
    assert neighbors.missing_pairs(pos, box, 5.0, idx, mask) == 0
    assert neighbors.missing_pairs(pos, box, 5.0, idx[:, :-1],
                                   mask[:, :-1]) > 0
