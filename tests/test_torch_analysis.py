"""The port's texture analysis against the JAX package's.

A B20 4x4x4 state with jitter and a Bloch helix of pitch 3/4 box along x
(plus noise), made with numpy from a seed, goes through both packages'
``spins_on_grid``, ``accumulate_spin_profile`` / ``pitch_from_profile``,
``helix_pitch`` along x and y, ``spin_structure_factor`` and
``topological_charge``: float32 within 1e-5 of each output's max (the
pitch exactly, the charge absolutely).  Also: the port's fixed-point ``segment_sum`` gives the
same bits whatever the order of its inputs, is closer to the float64
sums than float32 ``index_add_``, and raises where a bin's sum would leave
its fixed-point range.
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


def test_segment_sum_raises_past_its_range():
    """A bin whose sum leaves the int64 fixed-point range (2^23 at the
    2^-40 grid) raises instead of wrapping.  Five values of 2^21 in one
    bin add to 10,485,760; in int64 fixed point their sum wraps to
    -6,291,456, which ``segment_sum`` returned silently before it checked
    the range.  Just inside the range the sum stays exact."""
    vals = torch.full((5, 1), 2.0 ** 21, dtype=torch.float64)
    keys = torch.zeros(5, dtype=torch.int64)
    wrapped = torch.round(vals * 2.0 ** 40).to(torch.int64).sum()
    assert float(wrapped) / 2.0 ** 40 == -6291456.0      # the silent wrap
    assert float(ta.segment_sum(vals, keys, 1, plain=True)) == 10485760.0
    with pytest.raises(OverflowError, match="2\\^23"):
        ta.segment_sum(vals, keys, 2)
    assert float(ta.segment_sum(vals[:3], keys[:3], 1)) == 3 * 2.0 ** 21
    # a reduction over ranks adds the parts before the same check
    half = ta.fixed_point_sums(vals[:3], keys[:3], 1)
    with pytest.raises(OverflowError):
        ta.from_fixed_point(*(a + a for a in half), torch.float64)
    # inside a RangeGuard the check waits for the guard's caller, which
    # reads the largest bound of all the calls once
    with ta.RangeGuard() as guard:
        ta.segment_sum(vals[:3], keys[:3], 1)
        ta.segment_sum(vals, keys, 2)
    assert float(guard.bound) == 5 * 2.0 ** 21
    with pytest.raises(OverflowError, match="2\\^23"):
        guard.check(float(guard.bound))
    with ta.RangeGuard() as guard:
        ta.segment_sum(vals[:3], keys[:3], 1)
    guard.check(float(guard.bound))
