"""The yardstick's arithmetic: the H100's peaks and the work one NEP-SPIN
evaluation needs.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit: 67 TFLOP/s float32 outside the tensor cores (the NEP kernels run on
the CUDA cores), 3.35 TB/s HBM3.

Operations: frozen copies of the per-pair and per-atom operation counts of
the NEP-SPIN descriptor, network and their derivatives (the atom pass: the
descriptor, the network forward and backward and the adjoints; the force
pass: both halves of each pair's derivative), counted over the pairs inside
the cutoff, which the benchmark counts itself from the state it made.

Bytes: what the problem needs, whatever implements it: positions, spins and
types read once, one int32 index per pair inside the cutoff, the weights;
forces, fields and the energy written once.  Gathered per-pair blocks of
any implementation are not counted.
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12}      # FLOP/s, CUDA cores
HBM_BW = 3.35e12                     # bytes/s


def _monomials(l_max: int) -> int:
    """Monomials of degree 0..l_max in three variables."""
    return (l_max + 1) * (l_max + 2) * (l_max + 3) // 6


def flops_atom_pass(pot: dict, n_atoms: int, n_pairs: int) -> float:
    k, nm, d = pot["basis_size"], _monomials(pot["l_max"]), n_desc(pot)
    pair = (18 + 6 * k + 2 * pot["n_rad"] * k + 12 + 2 * nm
            + pot["n_ang"] * (2 * k + 2 * nm)
            + 30 + pot["n_spin"] * (2 * k + 18))
    atom = (3 * pot["n_ang"] * nm + 4 * d * pot["hidden"] + 6 * pot["hidden"]
            + 20 * pot["n_spin"] + 4 * pot["n_onsite"])
    return float(pair * n_pairs + atom * n_atoms)


def flops_force_pass(pot: dict, n_atoms: int, n_pairs: int) -> float:
    k, nm = pot["basis_size"], _monomials(pot["l_max"])
    pair = (21 + 12 * k + 4 * pot["n_rad"] * k + 12 + 2 * nm
            + pot["n_ang"] * (8 * k + 9 * nm) + 15 * nm + 2 * k + 24
            + 75 + pot["n_spin"] * (8 * k + 47))
    return float(pair * n_pairs + 6 * n_atoms)


def n_desc(pot: dict) -> int:
    return (pot["n_rad"] + pot["n_ang"] * pot["l_max"] + pot["n_onsite"]
            + 6 * pot["n_spin"])


def n_weights(pot: dict) -> int:
    t, k, h, d = pot["n_types"], pot["basis_size"], pot["hidden"], n_desc(pot)
    return (t * t * k * (pot["n_rad"] + pot["n_ang"] + pot["n_spin"])
            + t * d * h + 2 * t * h + t + d)


def evaluation(pot: dict, n_atoms: int, n_pairs: int,
               itemsize: int = 4) -> dict:
    """FLOPs and bytes of one evaluation of ``n_atoms`` atoms with
    ``n_pairs`` ordered pairs inside the cutoff, and the least time the
    card could take."""
    flops = (flops_atom_pass(pot, n_atoms, n_pairs)
             + flops_force_pass(pot, n_atoms, n_pairs))
    n_bytes = (n_atoms * 6 * itemsize                  # positions, spins
               + n_atoms * 4 + n_pairs * 4             # types, indices
               + n_weights(pot) * itemsize
               + n_atoms * 6 * itemsize + itemsize)    # F, H, E
    t_ops = flops / PEAK_FLOPS["float32"]
    t_bytes = n_bytes / HBM_BW
    return {"flops": flops, "bytes": n_bytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
