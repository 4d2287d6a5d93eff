"""The yardstick's arithmetic (perfbench/harness/work.py) against hand
counts for the small spec."""
import pytest

from perfbench.harness import work

SMALL = {"cutoff": 5.0, "basis_size": 6, "n_rad": 4, "n_ang": 2, "l_max": 2,
         "n_spin": 2, "n_onsite": 3, "n_types": 2, "hidden": 32}


def test_descriptor_width_and_weights():
    assert work.n_desc(SMALL) == 4 + 2 * 2 + 3 + 6 * 2 == 23
    # c_rad/c_ang/c_spin (2x2x(4+2+2)x6) + w1 (2x23x32) + b1, w2 (2x32
    # each) + b2 (2) + q_scale (23)
    assert work.n_weights(SMALL) == 192 + 1472 + 128 + 2 + 23


@pytest.mark.parametrize("n_atoms,n_pairs", [(1, 1), (1000, 44000)])
def test_operation_counts(n_atoms, n_pairs):
    # per pair, atom pass: 18 + 6k + 2 n_rad k + 12 + 2 nm + n_ang (2k + 2nm)
    # + 30 + n_spin (2k + 18), k = 6, nm = 10 monomials up to degree 2
    pair1 = 18 + 36 + 48 + 12 + 20 + 2 * (12 + 20) + 30 + 2 * (12 + 18)
    atom1 = 3 * 2 * 10 + 4 * 23 * 32 + 6 * 32 + 20 * 2 + 4 * 3
    assert (pair1, atom1) == (288, 3248)
    assert work.flops_atom_pass(SMALL, n_atoms, n_pairs) == \
        pair1 * n_pairs + atom1 * n_atoms
    pair2 = (21 + 72 + 96 + 12 + 20 + 2 * (48 + 90) + 150 + 12 + 24 + 75
             + 2 * (48 + 47))
    assert pair2 == 948
    assert work.flops_force_pass(SMALL, n_atoms, n_pairs) == \
        pair2 * n_pairs + 6 * n_atoms


def test_bytes_count_the_problem_not_the_blocks():
    n, p = 1000, 44000
    one = work.evaluation(SMALL, n, p)
    # positions + spins in, types + one index a pair, weights, F + H + E out
    want = n * 24 + n * 4 + p * 4 + work.n_weights(SMALL) * 4 + n * 24 + 4
    assert one["bytes"] == want
    assert one["flops"] == (work.flops_atom_pass(SMALL, n, p)
                            + work.flops_force_pass(SMALL, n, p))
    assert one["bound_by"] == "operations"
    assert one["bound_s"] == pytest.approx(one["flops"] / 67e12)
