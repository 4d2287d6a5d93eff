"""Port neighbor tables and gathers against the JAX package.

Row order inside a table is not part of the contract (``torch.topk`` and
``jax.lax.top_k`` may break ties differently), so the tables are compared
as neighbor sets per row.  Gathers, the skin test and the cell ordering are
compared on the same inputs; the pair-force scatter sums in another order,
so it is held to f32 roundoff.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.md import neighbor as jnb
from repro_torch.md import neighbor as tnb
from repro_torch.md.lattice import b20_fege, simple_cubic


def _system(lattice, cells, seed, jitter=0.08):
    lat = b20_fege() if lattice == "b20" else simple_cubic()
    pos, types, box = lat.supercell(*cells)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + jitter * rng.standard_normal(pos.shape), box)
    return pos.astype(np.float32), types, box.astype(np.float32)


def _row_sets(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask)
    return [frozenset(idx[i][mask[i]].tolist()) for i in range(idx.shape[0])]


def _t(x):
    return torch.as_tensor(np.array(x))


TABLES = [
    # (lattice, cells, cutoff, capacity, skin, cell list, cell capacity)
    ("b20", (3, 3, 3), 5.0, 64, 0.5, False, None),
    ("sc", (4, 4, 4), 5.0, 20, 0.3, False, None),
    ("b20", (4, 4, 4), 5.0, 64, 0.2, True, 48),
    ("b20", (4, 4, 4), 4.0, 24, 0.3, True, 40),   # capacity truncates
]


@pytest.mark.parametrize("case", range(len(TABLES)))
def test_table_neighbor_sets_match(case):
    lat, cells, rc, cap, skin, cell, ccap = TABLES[case]
    pos, _, box = _system(lat, cells, seed=case)
    if cell:
        ref = jnb.cell_neighbor_table(jnp.asarray(pos), jnp.asarray(box), rc,
                                      cap, cell_capacity=ccap, skin=skin)
        got = tnb.cell_neighbor_table(_t(pos), _t(box), rc, cap,
                                      cell_capacity=ccap, skin=skin)
        assert not bool(jnb.bin_atoms(jnp.asarray(pos), jnp.asarray(box),
                                      jnb.grid_shape(box, rc, skin),
                                      ccap)[2])
    else:
        ref = jnb.dense_neighbor_table(jnp.asarray(pos), jnp.asarray(box), rc,
                                       cap, skin=skin)
        got = tnb.dense_neighbor_table(_t(pos), _t(box), rc, cap, skin=skin)
    assert got.idx.dtype == torch.int32 and got.idx.shape == ref.idx.shape
    assert _row_sets(got.idx, got.mask) == _row_sets(ref.idx, ref.mask)
    # invalid slots are self-padded
    n = pos.shape[0]
    rows = np.broadcast_to(np.arange(n)[:, None], got.idx.shape)
    mask = got.mask.numpy()
    np.testing.assert_array_equal(got.idx.numpy()[~mask], rows[~mask])
    assert got.cutoff == pytest.approx(rc + skin)


def _shared_table(seed=3):
    pos, types, box = _system("b20", (3, 3, 3), seed)
    ref = jnb.dense_neighbor_table(jnp.asarray(pos), jnp.asarray(box), 5.0, 64)
    got = tnb.NeighborTable(idx=_t(ref.idx), mask=_t(ref.mask), r0=_t(pos),
                            cutoff=float(ref.cutoff))
    return pos, types, box, ref, got


def test_gather_blocks_and_refresh_dr_identical():
    pos, types, box, rtab, ttab = _shared_table()
    rn = jnb.gather_blocks(jnp.asarray(pos), jnp.asarray(types), rtab,
                           jnp.asarray(box))
    tn = tnb.gather_blocks(_t(pos), _t(types).to(torch.int32), ttab, _t(box))
    np.testing.assert_array_equal(tn.tj.numpy(), np.asarray(rn.tj))
    np.testing.assert_array_equal(tn.dr.numpy(), np.asarray(rn.dr))
    moved = np.mod(pos + 0.03 * np.random.default_rng(9).standard_normal(
        pos.shape), box).astype(np.float32)
    rn2 = jnb.refresh_dr(rn, jnp.asarray(moved), jnp.asarray(box))
    tn2 = tnb.refresh_dr(tn, _t(moved), _t(box))
    np.testing.assert_array_equal(tn2.dr.numpy(), np.asarray(rn2.dr))
    assert tn2.idx is tn.idx and tn2.tj is tn.tj


def test_assemble_pair_forces_matches():
    pos, types, box, rtab, ttab = _shared_table(seed=4)
    rn = jnb.gather_blocks(jnp.asarray(pos), jnp.asarray(types), rtab,
                           jnp.asarray(box))
    tn = tnb.gather_blocks(_t(pos), _t(types).to(torch.int32), ttab, _t(box))
    g = np.random.default_rng(5).standard_normal(
        tuple(rn.dr.shape)).astype(np.float32)
    want = np.asarray(jnb.assemble_pair_forces(jnp.asarray(g), rn))
    got = tnb.assemble_pair_forces(_t(g), tn).numpy()
    # scatter-add order differs: f32 roundoff of a sum of ~100 terms
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cells", [(3, 3, 3), (4, 4, 4)])
def test_cell_order_and_needs_rebuild_identical(cells):
    pos, _, box = _system("b20", cells, seed=7)
    grid = jnb.grid_shape(box, 5.0, 0.5)
    want = np.asarray(jnb.cell_order(jnp.asarray(pos), jnp.asarray(box), grid))
    got = tnb.cell_order(_t(pos), _t(box), tnb.grid_shape(_t(box), 5.0, 0.5))
    assert tnb.grid_shape(_t(box), 5.0, 0.5) == grid
    np.testing.assert_array_equal(got.numpy(), want)

    rtab = jnb.dense_neighbor_table(jnp.asarray(pos), jnp.asarray(box), 5.0,
                                    64, skin=0.5)
    ttab = tnb.NeighborTable(idx=_t(rtab.idx), mask=_t(rtab.mask), r0=_t(pos),
                             cutoff=5.5)
    for shift in (0.1, 0.24, 0.26, 0.4):
        moved = pos.copy()
        moved[5, 1] += shift
        want = bool(jnb.needs_rebuild(rtab, jnp.asarray(moved),
                                      jnp.asarray(box), 0.5))
        got = bool(tnb.needs_rebuild(ttab, _t(moved), _t(box), 0.5))
        assert got == want


def test_bin_atoms_complete_and_cell_overflow_raises():
    pos, _, box = _system("b20", (4, 4, 4), seed=2)
    grid = tnb.grid_shape(_t(box), 5.0, 0.2)
    cells, cmask, overflow = tnb.bin_atoms(_t(pos), _t(box), grid, 48)
    assert not bool(overflow)
    assert sorted(cells[cmask].tolist()) == list(range(pos.shape[0]))
    # the reference flags the same overflow, then drops atoms silently
    _, _, ref_over = jnb.bin_atoms(jnp.asarray(pos), jnp.asarray(box), grid, 8)
    _, _, got_over = tnb.bin_atoms(_t(pos), _t(box), grid, 8)
    assert bool(ref_over) and bool(got_over)
    with pytest.raises(RuntimeError, match="overflow"):
        tnb.cell_neighbor_table(_t(pos), _t(box), 5.0, 64, cell_capacity=8,
                                skin=0.2)
