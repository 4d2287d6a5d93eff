"""Port descriptor and autograd NEP-SPIN potential against the JAX package.

The four spec/lattice cases of ``tests/test_kernels_nep.py`` (``CASES``):
both packages get the same positions and spins (numpy, seeded), the same
weights (the reference's ``init_params`` through ``params_from_jax``) and
the same neighbor table, at f32.  Accumulators, descriptors and the
autograd (E, F, H_eff) agree within 2e-5 relative, the reference suite's
own bar for its kernel against its oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import descriptor as jdesc
from repro.core import potential as jpot
from repro.md import neighbor as jnb
from repro_torch.core import descriptor as tdesc
from repro_torch.core import potential as tpot
from repro_torch.md import neighbor as tnb
from repro_torch.md.lattice import b20_fege, simple_cubic

# (lattice, cells, capacity, spec kwargs) - tests/test_kernels_nep.py:30
CASES = [
    ("b20", (2, 2, 2), 48, dict(l_max=2, n_ang=2, n_rad=4, n_spin=2,
                                basis_size=6)),
    ("sc", (3, 3, 3), 12, dict(l_max=3, n_ang=2, n_rad=3, n_spin=2,
                               basis_size=5, n_types=1)),
    ("b20", (2, 2, 2), 48, dict(l_max=4, n_ang=3, n_rad=4, n_spin=3,
                                basis_size=6)),
    ("sc", (3, 3, 3), 12, dict(l_max=2, n_ang=2, n_rad=4, n_spin=2,
                               basis_size=6, n_types=1, spin=False)),
]
RTOL = 2e-5


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _case(case):
    """Shared inputs: reference objects and their port twins (f32, CPU)."""
    lat, cells, cap, spec_kw = CASES[case]
    lattice = b20_fege() if lat == "b20" else simple_cubic()
    pos, types, box = lattice.supercell(*cells)
    rng = np.random.default_rng(case)
    pos = np.mod(pos + 0.08 * rng.standard_normal(pos.shape), box)
    spin = rng.standard_normal(pos.shape)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    spin[lattice.moments[types] == 0] = 0.0
    pos, spin, box = (a.astype(np.float32) for a in (pos, spin, box))
    jspec = jdesc.NEPSpinSpec(**spec_kw)
    jparams = jpot.init_params(jspec, jax.random.PRNGKey(10 + case),
                               dtype=jnp.float32)
    jtab = jnb.dense_neighbor_table(jnp.asarray(pos), jnp.asarray(box),
                                    jspec.cutoff, cap)
    jnbh = jnb.gather_blocks(jnp.asarray(pos), jnp.asarray(types), jtab,
                             jnp.asarray(box))
    field = (0.0, 0.1, 0.2) if jspec.spin else None
    mom = np.asarray([1.16, 0.0], np.float32)[:jspec.n_types]
    ref = dict(spec=jspec, params=jparams, nbh=jnbh, spin=jnp.asarray(spin),
               types=jnp.asarray(types), mom=jnp.asarray(mom),
               field=None if field is None else jnp.asarray(field))

    tspec = tdesc.NEPSpinSpec(**spec_kw)
    tparams = tpot.params_from_jax([np.asarray(x) for x in jparams],
                                   device="cpu", dtype=torch.float32)
    ttab = tnb.NeighborTable(idx=_t(jtab.idx), mask=_t(jtab.mask),
                             r0=_t(pos), cutoff=float(jtab.cutoff))
    ttypes = _t(types, torch.int32)
    tnbh = tnb.gather_blocks(_t(pos), ttypes, ttab, _t(box))
    port = dict(spec=tspec, params=tparams, nbh=tnbh, spin=_t(spin),
                types=ttypes, field=field, mom=_t(mom))
    return ref, port


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-9)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) / scale < rtol


@pytest.mark.parametrize("case", range(len(CASES)))
def test_accumulate_finalize_match(case):
    ref, port = _case(case)
    jn, tn = ref["nbh"], port["nbh"]
    jdist = jnp.sqrt(jnp.sum(jn.dr * jn.dr, axis=-1) + 1e-30)
    jacc = jdesc.accumulate(
        ref["spec"], ref["params"].desc_params(),
        jdesc.init_accumulators(ref["spec"], jn.dr.shape[:-2], jnp.float32),
        jn.dr, jdist, jn.mask, ref["types"], jn.tj, ref["spin"],
        ref["spin"][jn.idx])
    tdist = torch.sqrt(torch.sum(tn.dr * tn.dr, dim=-1) + 1e-30)
    tacc = tdesc.accumulate(
        port["spec"], port["params"].desc_params(),
        tdesc.init_accumulators(port["spec"], tn.dr.shape[:-2],
                                torch.float32),
        tn.dr, tdist, tn.mask, port["types"], tn.tj, port["spin"],
        port["spin"][tn.idx.long()])
    assert set(tacc) == set(jacc)
    for k in jacc:
        _close(tacc[k], jacc[k])
    _close(tdesc.finalize(port["spec"], tacc, port["spin"]),
           jdesc.finalize(ref["spec"], jacc, ref["spin"]))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_autograd_compute_matches(case):
    ref, port = _case(case)
    want = jpot.compute(ref["spec"], ref["params"], ref["nbh"], ref["spin"],
                        ref["types"], ref["field"], ref["mom"])
    got = tpot.compute(port["spec"], port["params"], port["nbh"],
                       port["spin"], port["types"], port["field"], port["mom"])
    e0 = float(want[0])
    assert abs(float(got[0]) - e0) / max(abs(e0), 1.0) < RTOL
    _close(got[1], want[1])     # F
    _close(got[2], want[2])     # H_eff


def test_init_params_shapes_and_symmetry():
    spec = tdesc.NEPSpinSpec()
    g = torch.Generator().manual_seed(0)
    p = tpot.init_params(spec, g, dtype=torch.float64, device="cpu")
    jp = jpot.init_params(jdesc.NEPSpinSpec(), jax.random.PRNGKey(0))
    for got, want in zip(p, jp):
        assert tuple(got.shape) == tuple(want.shape)
    assert spec.n_desc == 49
    for c in (p.c_rad, p.c_ang, p.c_spin):
        torch.testing.assert_close(c, c.transpose(0, 1))
    assert float(p.b1.abs().max()) == 0.0 and float(p.b2.abs().max()) == 0.0
    torch.testing.assert_close(p.q_scale, torch.ones_like(p.q_scale))
    # same spread as the reference: w1 ~ N(0, 1/D)
    assert abs(float(p.w1.std()) - (1.0 / spec.n_desc) ** 0.5) < 0.02
