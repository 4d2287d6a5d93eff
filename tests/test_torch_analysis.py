"""The port's texture analysis against the JAX package's.

A B20 4x4x4 state with jitter and a Bloch helix of pitch 3/4 box along x
(plus noise), made with numpy from a seed, goes through both packages'
``spins_on_grid``, ``accumulate_spin_profile`` / ``pitch_from_profile``,
``helix_pitch`` along x and y, ``spin_structure_factor`` and
``topological_charge``: float32 within 1e-5 of each output's max (the
pitch exactly, the charge absolutely).  Also: the port's fixed-point ``segment_sum`` gives the
same bits whatever the order of its inputs, and is closer to the float64
sums than float32 ``index_add_``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import analysis as ja
from repro_torch.md import analysis as ta
from repro_torch.md.lattice import b20_fege
from torch_one_thread import one_torch_thread  # noqa: F401


def _arrays(seed=0):
    lat = b20_fege()
    pos, types, box = lat.supercell(4, 4, 4)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + 0.1 * rng.standard_normal(pos.shape), box)
    phase = 2 * np.pi * pos[:, 0] / (0.75 * box[0])
    spin = np.stack([0.2 * rng.standard_normal(len(pos)), np.cos(phase),
                     np.sin(phase)], axis=-1)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    return pos, spin, box


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


CALLS = {
    "spins_on_grid_1d": lambda m, p, s, b: m.spins_on_grid(p, s, b, (16,)),
    "spins_on_grid_2d": lambda m, p, s, b: m.spins_on_grid(p, s, b, (8, 6)),
    "profile": lambda m, p, s, b: m.accumulate_spin_profile(p, s, b, 0, 32),
    "profile_y": lambda m, p, s, b: m.accumulate_spin_profile(p, s, b, 1,
                                                              16),
    "pitch_x": lambda m, p, s, b: m.helix_pitch(p, s, b, axis=0, n_bins=32),
    "pitch_y": lambda m, p, s, b: m.helix_pitch(p, s, b, axis=1, n_bins=16),
    "pitch_from_profile": lambda m, p, s, b: m.pitch_from_profile(
        m.accumulate_spin_profile(p, s, b, 0, 24), b, 0),
    "structure_factor": lambda m, p, s, b: m.spin_structure_factor(
        p, s, b, n_bins=32, axis=0),
    "charge": lambda m, p, s, b: m.topological_charge(p, s, b, grid=(8, 8)),
    "spin_grid": lambda m, p, s, b: m.accumulate_spin_grid(p, s, b, (8, 8)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_matches_reference_f32(name):
    pos, spin, box = (np.asarray(x, np.float32) for x in _arrays())
    want = np.asarray(CALLS[name](ja, *(jnp.asarray(x) for x in (pos, spin,
                                                                  box))))
    got = CALLS[name](ta, *(torch.tensor(x) for x in (pos, spin,
                                                      box))).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name.startswith("pitch"):
        assert got == want
    elif name == "charge":          # an integer, here 0: absolute
        assert abs(float(got) - float(want)) < 1e-5
    else:
        assert _rel(got, want) < 1e-5, name


def test_helix_pitch_reads_the_helix():
    pos, spin, box = _arrays()
    got = float(ta.helix_pitch(*(torch.tensor(x) for x in (pos, spin, box)),
                               axis=0, n_bins=32))
    # k* = 4/3 of the box is not a mode; the nearest mode is k = 1 (box)
    assert got == pytest.approx(box[0])


def test_segment_sum_is_order_free():
    g = torch.Generator().manual_seed(0)
    vals = torch.randn((5000, 3), generator=g)
    keys = torch.randint(0, 37, (5000,), generator=g)
    want = ta.segment_sum(vals, keys, 40)
    for seed in range(3):
        perm = torch.randperm(5000, generator=torch.Generator()
                              .manual_seed(seed))
        assert torch.equal(ta.segment_sum(vals[perm], keys[perm], 40), want)
    exact = torch.zeros(40, 3, dtype=torch.float64).index_add_(
        0, keys, vals.double())
    plain = ta.segment_sum(vals, keys, 40, plain=True)
    err_fixed = float((want.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err_fixed <= err_plain and err_fixed < 1e-6
    assert torch.all(want[37:] == 0)
    bad = vals.clone()
    bad[7, 1] = float("nan")
    assert torch.isnan(ta.segment_sum(bad, keys, 40)).all()
