"""K1 / K2 plain versions and ``nep_compute`` against the JAX kernels.

The JAX kernels run as the reference suite runs them on the CPU
(``mode="xla_tiled"``) and its autodiff oracle
``kernels/nep/ref.py:nep_energy_forces_field_ref``; both packages get the
same numpy inputs and weights at f32 (rtol 2e-5, atol 1e-5 per element for
K1's outputs; 2e-5 of each output's max for forces and fields).  The four
``CASES`` of ``tests/test_kernels_nep.py`` plus one case at the production
spec (B20 2x2x2, capacity 64).

The closed-form mirror of the CUDA kernels' hand-derived derivatives
(``atom_pass_closed`` / ``force_pass_closed``) is held against the autograd
plain versions at f64 within 1e-10.  The CUDA kernels themselves run only
on the card, where ``chip_smoke.py`` compares them with the plain versions.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import descriptor as jdesc
from repro.core import potential as jpot
from repro.kernels.nep import kernel as jkern
from repro.kernels.nep.ops import nep_compute as j_nep_compute
from repro.kernels.nep.ref import nep_energy_forces_field_ref
from repro.md import neighbor as jnb
from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.potential import init_params, params_from_jax
from repro_torch.kernels.nep import kernel as tkern
from repro_torch.kernels.nep import ref as tref
from repro_torch.kernels.nep.layout import (acc_keys, acc_width, pack_abar,
                                            unpack_abar)
from repro_torch.kernels.nep.ops import nep_compute, nep_energy_forces_field
from repro_torch.md import neighbor as tnb
from repro_torch.md.lattice import b20_fege, simple_cubic

PRODUCTION = dict(cutoff=5.0, basis_size=8, n_rad=6, n_ang=4, l_max=4,
                  n_spin=4, n_types=2, hidden=32)
# (lattice, cells, capacity, spec kwargs): tests/test_kernels_nep.py:30 and
# the production spec
CASES = [
    ("b20", (2, 2, 2), 48, dict(l_max=2, n_ang=2, n_rad=4, n_spin=2,
                                basis_size=6)),
    ("sc", (3, 3, 3), 12, dict(l_max=3, n_ang=2, n_rad=3, n_spin=2,
                               basis_size=5, n_types=1)),
    ("b20", (2, 2, 2), 48, dict(l_max=4, n_ang=3, n_rad=4, n_spin=3,
                                basis_size=6)),
    ("sc", (3, 3, 3), 12, dict(l_max=2, n_ang=2, n_rad=4, n_spin=2,
                               basis_size=6, n_types=1, spin=False)),
    ("b20", (2, 2, 2), 64, PRODUCTION),
]


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _inputs(lat, cells, seed, dtype=np.float32):
    lattice = b20_fege() if lat == "b20" else simple_cubic()
    pos, types, box = lattice.supercell(*cells)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + 0.08 * rng.standard_normal(pos.shape), box)
    spin = rng.standard_normal(pos.shape)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    spin[lattice.moments[types] == 0] = 0.0
    return pos.astype(dtype), spin.astype(dtype), types, box.astype(dtype)


@functools.lru_cache(maxsize=None)
def _case(case):
    lat, cells, cap, spec_kw = CASES[case]
    pos, spin, types, box = _inputs(lat, cells, seed=20 + case)
    jspec = jdesc.NEPSpinSpec(**spec_kw)
    # weights drawn as tests/test_kernels_nep.py draws them for CASES
    jparams = jpot.init_params(jspec, jax.random.PRNGKey(10 + case),
                               dtype=jnp.float32)
    jtab = jnb.dense_neighbor_table(jnp.asarray(pos), jnp.asarray(box),
                                    jspec.cutoff, cap)
    jnbh = jnb.gather_blocks(jnp.asarray(pos), jnp.asarray(types), jtab,
                             jnp.asarray(box))
    mom = np.asarray([1.16, 0.0], np.float32)[:jspec.n_types]
    field = (0.0, 0.1, 0.2) if jspec.spin else None
    spec = NEPSpinSpec(**spec_kw)
    params = params_from_jax([np.asarray(x) for x in jparams], device="cpu",
                             dtype=torch.float32)
    ttypes = _t(types, torch.int32)
    nbh = tnb.gather_blocks(
        _t(pos), ttypes, tnb.NeighborTable(idx=_t(jtab.idx),
                                           mask=_t(jtab.mask), r0=_t(pos),
                                           cutoff=float(jtab.cutoff)),
        _t(box))
    return dict(pos=pos, spin=spin, types=types, box=box, jspec=jspec,
                jparams=jparams, jtab=jtab, jnbh=jnbh, mom=mom, field=field,
                spec=spec, params=params, ttypes=ttypes, nbh=nbh)


def _padded_jax_blocks(c):
    """The reference kernels want N padded to a TILE_ATOMS multiple."""
    n = c["pos"].shape[0]
    npad = -(-n // jkern.TILE_ATOMS) * jkern.TILE_ATOMS
    jn = c["jnbh"]
    spin = jnp.asarray(c["spin"])

    def pad(x):
        x = jnp.asarray(x)
        return jnp.pad(x, [(0, npad - n)] + [(0, 0)] * (x.ndim - 1))

    return dict(dr=pad(jn.dr), mask=pad(jn.mask), amask=pad(jnp.ones(n, bool)),
                ti=pad(c["types"]), tj=pad(jn.tj), si=pad(spin),
                sj=pad(spin[jn.idx]), idx=pad(jn.idx)), n


@functools.lru_cache(maxsize=None)
def _jax_passes(case):
    """The reference K1 and K2 (``xla_tiled``) on the case's blocks."""
    c = _case(case)
    jb, n = _padded_jax_blocks(c)
    k1 = jkern.nep_atom_pass(c["jspec"], c["jparams"], jb["dr"], jb["mask"],
                             jb["amask"], jb["ti"], jb["tj"], jb["si"],
                             jb["sj"], mode="xla_tiled")
    abar = k1[2]
    abar_j = {k: v[jb["idx"]] for k, v in abar.items()}
    k2 = jkern.nep_force_pass(c["jspec"], c["jparams"], jb["dr"], jb["mask"],
                              jb["ti"], jb["tj"], jb["si"], jb["sj"], abar,
                              abar_j, mode="xla_tiled")
    return k1, k2, n


def _port_blocks(c):
    nbh = c["nbh"]
    spin = _t(c["spin"])
    return (nbh.dr, nbh.mask, c["ttypes"], nbh.tj, spin,
            spin[nbh.idx.long()])


def _rel_close(got, want, rtol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-9)
    assert float(np.abs(got - want).max()) / scale < rtol


@pytest.mark.parametrize("case", range(len(CASES)))
def test_atom_pass_plain_matches_jax(case):
    c = _case(case)
    (e0, h0, a0), _, n = _jax_passes(case)
    e1, h1, a1 = tref.atom_pass_plain(c["spec"], c["params"], *_port_blocks(c))
    assert a1.shape == (n, acc_width(c["spec"]))
    np.testing.assert_allclose(e1, np.asarray(e0)[:n], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(h1, np.asarray(h0)[:n], rtol=2e-5, atol=1e-5)
    leaves = unpack_abar(c["spec"], a1)
    assert list(leaves) == jkern.acc_keys(c["jspec"]) == acc_keys(c["spec"])
    for k, v in leaves.items():
        np.testing.assert_allclose(v, np.asarray(a0[k])[:n], rtol=2e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_force_pass_plain_matches_jax(case):
    c = _case(case)
    (_, _, abar), (f0, h0), n = _jax_passes(case)
    # the same adjoints for both, packed for the port
    flat = pack_abar(c["spec"], {k: _t(np.asarray(v)[:n])
                                 for k, v in abar.items()})
    dr, mask, ti, tj, si, sj = _port_blocks(c)
    f1, h1 = tref.force_pass_plain(c["spec"], c["params"], dr, mask,
                                   c["nbh"].idx, ti, tj, si, sj, flat)
    _rel_close(f1, np.asarray(f0)[:n])
    _rel_close(h1, np.asarray(h0)[:n])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_nep_compute_matches_jax_and_oracle(case):
    c = _case(case)
    jfield = None if c["field"] is None else jnp.asarray(c["field"])
    jmom = jnp.asarray(c["mom"])
    jspin, jtypes = jnp.asarray(c["spin"]), jnp.asarray(c["types"])
    want_k = j_nep_compute(c["jspec"], c["jparams"], c["jnbh"], jspin, jtypes,
                           jfield, jmom, mode="xla_tiled")
    want_o = nep_energy_forces_field_ref(
        c["jspec"], c["jparams"], jnp.asarray(c["pos"]), jspin, jtypes,
        c["jtab"], jnp.asarray(c["box"]), jfield, jmom)
    got = nep_compute(c["spec"], c["params"], c["nbh"], _t(c["spin"]),
                      c["ttypes"], c["field"], _t(c["mom"]))
    whole = nep_energy_forces_field(
        c["spec"], c["params"], _t(c["pos"]), _t(c["spin"]), c["ttypes"],
        tnb.NeighborTable(idx=_t(c["jtab"].idx), mask=_t(c["jtab"].mask),
                          r0=_t(c["pos"]), cutoff=float(c["jtab"].cutoff)),
        _t(c["box"]), c["field"], _t(c["mom"]))
    for a, b in zip(whole, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for want in (want_k, want_o):
        e0 = float(want[0])
        assert abs(float(got[0]) - e0) / max(abs(e0), 1.0) < 2e-5
        _rel_close(got[1], want[1])
        _rel_close(got[2], want[2])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_closed_form_mirror_matches_autograd_f64(case):
    lat, cells, cap, spec_kw = CASES[case]
    pos, spin, types, box = _inputs(lat, cells, seed=40 + case,
                                    dtype=np.float64)
    spec = NEPSpinSpec(**spec_kw)
    params = init_params(spec, torch.Generator().manual_seed(case),
                         dtype=torch.float64, device="cpu")
    ttypes = _t(types, torch.int32)
    tab = tnb.dense_neighbor_table(_t(pos), _t(box), spec.cutoff, cap)
    nbh = tnb.gather_blocks(_t(pos), ttypes, tab, _t(box))
    s = _t(spin)
    blocks = (nbh.dr, nbh.mask, ttypes, nbh.tj, s, s[nbh.idx.long()])
    plain = tref.atom_pass_plain(spec, params, *blocks)
    closed = tref.atom_pass_closed(spec, params, *blocks)
    for got, want in zip(closed, plain):
        _rel_close(got, want, rtol=1e-10)
    dr, mask, ti, tj, si, sj = blocks
    plain = tref.force_pass_plain(spec, params, dr, mask, nbh.idx, ti, tj,
                                  si, sj, plain[2])
    closed = tref.force_pass_closed(spec, params, dr, mask, nbh.idx, ti, tj,
                                    si, sj, closed[2])
    for got, want in zip(closed, plain):
        _rel_close(got, want, rtol=1e-10)


def test_plain_versions_walk_row_blocks(monkeypatch):
    """Row-blocked plain passes equal the one-block result."""
    c = _case(0)
    blocks = _port_blocks(c)
    whole = tref.atom_pass_plain(c["spec"], c["params"], *blocks)
    fw = tref.force_pass_plain(c["spec"], c["params"], blocks[0], blocks[1],
                               c["nbh"].idx, *blocks[2:], whole[2])
    monkeypatch.setattr(tref, "PLAIN_ROWS", 7)
    split = tref.atom_pass_plain(c["spec"], c["params"], *blocks)
    fs = tref.force_pass_plain(c["spec"], c["params"], blocks[0], blocks[1],
                               c["nbh"].idx, *blocks[2:], whole[2])
    for a, b in zip(whole + fw, split + fs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_wrappers_dispatch_cpu_to_plain_and_check_inputs():
    c = _case(0)
    blocks = _port_blocks(c)
    n0, n1 = tkern.nep_atom_pass.launches, tkern.nep_force_pass.launches
    got = tkern.nep_atom_pass(c["spec"], c["params"], *blocks)
    want = tref.atom_pass_plain(c["spec"], c["params"], *blocks)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tkern.nep_force_pass(c["spec"], c["params"], blocks[0], blocks[1],
                         c["nbh"].idx, *blocks[2:], got[2])
    # the CPU route launches nothing
    assert (tkern.nep_atom_pass.launches, tkern.nep_force_pass.launches) == \
        (n0, n1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tkern.nep_atom_pass(c["spec"], c["params"],
                            *(b.to("meta") for b in blocks))
    for bad in (dict(l_max=5), dict(hidden=65), dict(n_types=5),
                dict(basis_size=17)):
        with pytest.raises(ValueError):
            tkern.check_spec(NEPSpinSpec(**bad))
    tkern.check_spec(NEPSpinSpec(**PRODUCTION))
    assert acc_width(NEPSpinSpec(**PRODUCTION)) == 182


@pytest.mark.parametrize("spec_kw, body", [
    (PRODUCTION, "warp"),
    (dict(cutoff=5.0, basis_size=6, n_rad=4, n_ang=2, l_max=2, n_spin=2,
          n_types=2, hidden=16), "warp"),
    (CASES[2][3], "thread"),
    (dict(PRODUCTION, spin=False), "thread"),
    (dict(PRODUCTION, n_types=1), "thread"),
])
def test_force_pass_body_choice(spec_kw, body):
    """K2's warp body serves the specs it is compiled for (the production
    and smoke specs of configs/fege_spinlattice.py); any other spec within
    SPEC_BOUNDS goes to the thread-per-atom body."""
    assert tkern.force_pass_body(NEPSpinSpec(**spec_kw)) == body


SMOKE = dict(cutoff=5.0, basis_size=6, n_rad=4, n_ang=2, l_max=2, n_spin=2,
             n_types=2, hidden=16)


@pytest.mark.parametrize("spec_kw, body", [
    (PRODUCTION, "warp"),
    (SMOKE, "warp"),
    (CASES[0][3], "warp"),      # the md_loop scenario's spec
    (CASES[2][3], "thread"),
    (dict(PRODUCTION, spin=False), "thread"),
    (dict(PRODUCTION, n_types=1), "thread"),
    (dict(PRODUCTION, hidden=16), "thread"),
    (dict(PRODUCTION, n_onsite=2), "thread"),
])
def test_atom_pass_body_choice(spec_kw, body):
    """K1's warp body serves the specs it is compiled for, MLP width and
    onsite features included; any other spec within SPEC_BOUNDS goes to
    the thread-per-atom body."""
    assert tkern.atom_pass_body(NEPSpinSpec(**spec_kw)) == body


def test_force_pass_body_covers_the_fege_configs():
    from repro_torch.configs.fege_spinlattice import config, smoke_config
    for cfg in (config(), smoke_config()):
        assert tkern.force_pass_body(cfg.spec) == "warp"
        assert tkern.atom_pass_body(cfg.spec) == "warp"
    for fn in (tkern.nep_atom_pass, tkern.nep_force_pass):
        assert set(fn.body_launches) == set(tkern.BODIES)


def test_warp_specs_match_the_cuda_instantiations():
    """WARP_SPECS in kernel.py and the ``Sizes<...>`` instantiations of
    csrc/nep_common.cuh name the same specs, in the same field order
    (n_types, basis_size, n_rad, n_ang, l_max, n_spin, hidden, n_onsite),
    and both K1's and K2's warp bodies dispatch on each of them (K2's
    ``is<S>`` matches the six carrier fields only, so a spec that shares
    them with one K2 names runs that instantiation)."""
    import re
    from pathlib import Path
    csrc = Path(tkern.__file__).parent / "csrc"
    common = (csrc / "nep_common.cuh").read_text()
    decl = dict(re.findall(r"^using (\w+Sizes) = Sizes<([\d,\s]+)>;", common,
                           flags=re.M))
    sizes = {name: tuple(int(x) for x in s.split(","))
             for name, s in decl.items()}
    assert sorted(sizes.values()) == sorted(tkern.WARP_SPECS)
    k1 = (csrc / "nep_atom_pass.cu").read_text()
    k2 = (csrc / "nep_force_pass.cu").read_text()
    k2_carriers = {sizes[name][:6] for name in sizes
                   if f"is<{name}>(sp)" in k2}
    for name, fields in sizes.items():
        assert fields[:6] in k2_carriers, name
        assert f"is_atom<{name}>(sp)" in k1, name


def test_wrappers_reject_a_warp_body_not_compiled():
    """``body="warp"`` for a spec without a warp instantiation raises on
    any device; ``"thread"`` takes it.  Case 0's spec (the md_loop
    scenario's) has both warp bodies; at hidden 8 it shares K2's carrier
    sizes with the smoke spec but no K1 instantiation, so only K1
    refuses."""
    narrow = NEPSpinSpec(**dict(CASES[0][3], hidden=8))
    for case, spec, k1_ok, k2_ok in ((1, None, False, False),
                                     (0, None, True, True),
                                     (0, narrow, False, True)):
        c = _case(case)
        spec = c["spec"] if spec is None else spec
        params = c["params"] if spec is c["spec"] else init_params(
            spec, torch.Generator().manual_seed(0), device="cpu")
        blocks = _port_blocks(c)
        abar = tkern.nep_atom_pass(spec, params, *blocks, body="thread")[2]
        k2_args = (spec, params, blocks[0], blocks[1], c["nbh"].idx,
                   *blocks[2:], abar)
        for fn, args, ok in ((tkern.nep_atom_pass, (spec, params, *blocks),
                              k1_ok),
                             (tkern.nep_force_pass, k2_args, k2_ok)):
            fn(*args, body="thread")
            if ok:
                fn(*args, body="warp")
            else:
                with pytest.raises(ValueError, match="no 'warp' body"):
                    fn(*args, body="warp")
            with pytest.raises(ValueError, match="no 'block' body"):
                fn(*args, body="block")


def _replica_blocks(c, r=3, seed=5):
    """A replica batch on case ``c``'s table: per-replica jittered
    positions' ``dr`` and random spins, the table shared."""
    rng = np.random.default_rng(seed)
    nbh = c["nbh"]
    box, idx = _t(c["box"]), nbh.idx.long()
    pos = _t(c["pos"]) + 0.02 * _t(rng.standard_normal((r,) + c["pos"].shape),
                                   torch.float32)
    dr = pos[:, idx] - pos[:, :, None, :]
    dr = dr - box * torch.round(dr / box)
    spin = torch.nn.functional.normalize(
        _t(rng.standard_normal((r,) + c["spin"].shape), torch.float32),
        dim=-1) * (_t(c["spin"]).norm(dim=-1, keepdim=True) > 0)
    return dr, spin, spin[:, idx]


@pytest.mark.parametrize("case", [0, 4])
def test_batched_plain_passes_are_per_replica(case):
    """K1's and K2's plain versions take the kernels' replica batches (a
    leading R on dr, si, sj, abar and the outputs; one table): replica r's
    outputs are bitwise the flat call's on replica r's inputs."""
    c = _case(case)
    nbh, spec, params, ti = c["nbh"], c["spec"], c["params"], c["ttypes"]
    dr, si, sj = _replica_blocks(c)
    k1 = tref.atom_pass_plain(spec, params, dr, nbh.mask, ti, nbh.tj, si, sj)
    k2 = tref.force_pass_plain(spec, params, dr, nbh.mask, nbh.idx, ti,
                               nbh.tj, si, sj, k1[2])
    assert k1[0].shape == (3, ti.shape[0]) and k2[0].shape == si.shape
    for r in range(3):
        f1 = tref.atom_pass_plain(spec, params, dr[r], nbh.mask, ti, nbh.tj,
                                  si[r], sj[r])
        f2 = tref.force_pass_plain(spec, params, dr[r], nbh.mask, nbh.idx,
                                   ti, nbh.tj, si[r], sj[r], k1[2][r])
        for got, want in zip(k1 + k2, f1 + f2):
            assert torch.equal(got[r], want)
    # the wrappers route the batch to the same plain versions on the CPU
    w1 = tkern.nep_atom_pass(spec, params, dr, nbh.mask, ti, nbh.tj, si, sj)
    assert all(torch.equal(a, b) for a, b in zip(w1, k1))


def test_batched_nep_compute_is_per_replica():
    """``nep_compute`` on a replica batch (one gather, one K1 and one K2
    call, a field per replica): energies, forces and fields bitwise the
    flat call's on each replica."""
    c = _case(0)
    nbh, spec, params, ti = c["nbh"], c["spec"], c["params"], c["ttypes"]
    dr, si, _ = _replica_blocks(c)
    fields = torch.tensor([[0.0, 0.0, 0.5], [0.1, 0.0, 0.0],
                           [0.0, -0.2, 0.3]])
    mom = torch.tensor(c["mom"])
    e, f, h = nep_compute(spec, params, nbh._replace(dr=dr), si, ti, fields,
                          mom)
    assert e.shape == (3,)
    for r in range(3):
        fe, ff, fh = nep_compute(spec, params, nbh._replace(dr=dr[r]), si[r],
                                 ti, fields[r], mom)
        assert torch.equal(e[r], fe) and torch.equal(f[r], ff)
        assert torch.equal(h[r], fh)
