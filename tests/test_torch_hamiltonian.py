"""The port's Heisenberg-DMI model against the JAX package's.

Inputs are made with numpy from a seed: a simple-cubic 3x3x3 lattice and a
B20 2x2x2 cell (Fe and non-magnetic Ge), both with 0.05 A of jitter and
random unit spins.  The reference evaluates them in an f64 subprocess
(x64) through both of its surfaces, the whole evaluation
``energy_forces_field`` (autodiff through the gather) and the gather-once
``compute``; the port's E, F and H_eff through both of its surfaces agree
within 1e-10 of each quantity's max at f64, and within 2e-5 at f32 against
the in-process (f32) reference.  Also: the port's two surfaces agree with
each other, the deterministic pair-reaction sum agrees with the plain
``index_add_`` one, ``pitch()`` is the reference's, forces match finite
differences, and the helix beats the ferromagnet with DMI.
"""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hamiltonian import HeisenbergDMIModel as JHam
from repro.md import neighbor as jnb
from repro_torch.core.hamiltonian import HeisenbergDMIModel as THam
from repro_torch.md import neighbor as tnb
from repro_torch.md.lattice import b20_fege, simple_cubic
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {
    "sc_default": ("sc", {}, None),
    "sc_all_terms": ("sc", dict(d0=0.002, kpd=0.0005, ka=0.001),
                     (0.0, 0.1, 0.5)),
    "b20": ("b20", dict(d0=0.008, kpd=0.001, ka=0.002,
                        ka_axis=(0.6, 0.0, 0.8)), (0.2, 0.0, 0.3)),
}
RUN = dict(cutoff=5.0, capacity=64, skin=0.5)

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.md.neighbor import dense_neighbor_table, gather_blocks

cases = eval(sys.argv[3])
d = np.load(sys.argv[1])
out = {}
for name, (lat, kw, field) in cases.items():
    pos, spin = jnp.asarray(d[lat + "_pos"]), jnp.asarray(d[lat + "_spin"])
    types, box = jnp.asarray(d[lat + "_types"]), jnp.asarray(d[lat + "_box"])
    ham = HeisenbergDMIModel(**kw)
    tab = dense_neighbor_table(pos, box, 5.0, 64, skin=0.5)
    f = None if field is None else jnp.asarray(field)
    for surf, res in (
            ("efh", ham.energy_forces_field(pos, spin, types, tab, box, f)),
            ("compute", ham.compute(gather_blocks(pos, types, tab, box),
                                    spin, types, f))):
        for q, v in zip("EFH", res):
            out[f"{name}_{surf}_{q}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
"""


def _system(lat_name, seed=0):
    lat = simple_cubic() if lat_name == "sc" else b20_fege()
    pos, types, box = lat.supercell(*((3, 3, 3) if lat_name == "sc"
                                      else (2, 2, 2)))
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + 0.05 * rng.standard_normal(pos.shape), box)
    spin = rng.standard_normal(pos.shape)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    spin[lat.moments[types] == 0] = 0.0
    return dict(pos=pos, spin=spin, types=types.astype(np.int32), box=box)


SYSTEMS = {k: _system(k) for k in ("sc", "b20")}


@pytest.fixture(scope="module")
def ref64(tmp_path_factory):
    d = tmp_path_factory.mktemp("ham")
    np.savez(d / "in.npz", **{f"{k}_{f}": v for k, s in SYSTEMS.items()
                              for f, v in s.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
         str(d / "out.npz"), repr(CASES)],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _port(name, dtype, plain=False):
    lat, kw, field = CASES[name]
    s = SYSTEMS[lat]
    pos, spin, box = (torch.tensor(s[k], dtype=dtype)
                      for k in ("pos", "spin", "box"))
    types = torch.tensor(s["types"])
    ham = THam(**kw)
    tab = tnb.dense_neighbor_table(pos, box, RUN["cutoff"], RUN["capacity"],
                                   RUN["skin"])
    nbh = tnb.gather_blocks(pos, types, tab, box, reverse=True)
    return {"efh": ham.energy_forces_field(pos, spin, types, tab, box, field),
            "compute": ham.compute(nbh, spin, types, field, plain=plain)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.mark.parametrize("surface", ["efh", "compute"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_f64_matches_reference(ref64, name, surface):
    got = _port(name, torch.float64)[surface]
    for q, v in zip("EFH", got):
        assert _rel(v, ref64[f"{name}_{surface}_{q}"]) < 1e-10, (name, q)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_matches_reference(name):
    lat, kw, field = CASES[name]
    s = SYSTEMS[lat]
    pos, spin, box = (jnp.asarray(s[k], jnp.float32)
                      for k in ("pos", "spin", "box"))
    types = jnp.asarray(s["types"])
    tab = jnb.dense_neighbor_table(pos, box, 5.0, 64, skin=0.5)
    f = None if field is None else jnp.asarray(field, jnp.float32)
    want = JHam(**kw).compute(jnb.gather_blocks(pos, types, tab, box), spin,
                              types, f)
    got = _port(name, torch.float32)
    for surface in ("efh", "compute"):
        for q, a, b in zip("EFH", got[surface], want):
            assert a.dtype == torch.float32
            assert _rel(a, b) < 2e-5, (name, surface, q)


@pytest.mark.parametrize("name", sorted(CASES))
def test_surfaces_and_assemblies_agree(name):
    det = _port(name, torch.float64)
    plain = _port(name, torch.float64, plain=True)["compute"]
    for a, b, c in zip(det["compute"], det["efh"], plain):
        assert _rel(a, b) < 1e-12 and _rel(a, c) < 1e-12


def test_pitch_matches_reference():
    for kw in ({}, dict(d0=0.008, j0=0.02), dict(r0=4.2)):
        assert THam(**kw).pitch() == JHam(**kw).pitch()
        assert THam(**kw).pitch(a=5.1) == JHam(**kw).pitch(a=5.1)


def test_forces_and_fields_match_finite_differences():
    lat, kw, field = CASES["b20"]
    s = SYSTEMS[lat]
    pos, spin, box = (torch.tensor(s[k], dtype=torch.float64)
                      for k in ("pos", "spin", "box"))
    types = torch.tensor(s["types"])
    ham = THam(**kw)
    tab = tnb.dense_neighbor_table(pos, box, 5.0, 64, 0.5)
    _, f, h = ham.energy_forces_field(pos, spin, types, tab, box, field)
    eps = 1e-4
    for x, grad, arg in ((pos, -f, 0), (spin, -h, 1)):
        for i, d in ((3, 0), (17, 2), (40, 1)):
            xp, xm = x.clone(), x.clone()
            xp[i, d] += eps
            xm[i, d] -= eps
            args_p = [pos, spin]
            args_m = [pos, spin]
            args_p[arg], args_m[arg] = xp, xm
            fd = (ham.energy(*args_p, types, tab, box, field)
                  - ham.energy(*args_m, types, tab, box, field)) / (2 * eps)
            assert abs(float(fd - grad[i, d])) < 1e-6 * float(
                grad.abs().max())


def test_helix_is_lower_than_ferro_with_dmi():
    from repro_torch.md.state import init_state
    lat = simple_cubic()
    ham = THam(cutoff=5.0, d0=0.0166 * np.tan(2 * np.pi / 8), gamma_d=0.0,
               gamma_j=0.0)
    st_f = init_state(lat, (8, 8, 8), spin_init="ferro_z", device="cpu")
    st_h = init_state(lat, (8, 8, 8), spin_init="helix_x",
                      helix_pitch=8 * lat.a, device="cpu")
    tab = tnb.dense_neighbor_table(st_f.pos, st_f.box, 5.0, 12)
    e_f = float(ham.energy(st_f.pos, st_f.spin, st_f.types, tab, st_f.box))
    e_h = float(ham.energy(st_h.pos, st_h.spin, st_h.types, tab, st_h.box))
    assert e_h < e_f


def test_reverse_sums_match_index_add():
    """The table's transpose sums what ``index_add_`` scatters, and the
    spin gather's gradient through it is autograd's own."""
    g = torch.Generator().manual_seed(3)
    idx = torch.randint(0, 50, (50, 9), generator=g, dtype=torch.int32)
    vals = torch.randn((50 * 9, 3), generator=g, dtype=torch.float64)
    rev = tnb.reverse_index(idx)
    assert int((rev < 50 * 9).sum()) == 50 * 9     # every slot once
    want = torch.zeros(50, 3, dtype=torch.float64).index_add_(
        0, idx.reshape(-1).long(), vals)
    torch.testing.assert_close(tnb.reverse_sum(vals, rev), want, rtol=1e-13,
                               atol=1e-13)
    nbh = tnb.Neighborhood(idx=idx, mask=torch.ones_like(idx, dtype=bool),
                           tj=idx, dr=torch.zeros(50, 9, 3), rev=rev)
    x = torch.randn((50, 3), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((50, 9, 3), generator=g, dtype=torch.float64)
    (gx,) = torch.autograd.grad((tnb.neighbor_rows(x, nbh) * w).sum(), x)
    (gp,) = torch.autograd.grad((tnb.neighbor_rows(x, nbh, plain=True)
                                 * w).sum(), x)
    torch.testing.assert_close(gx, gp, rtol=1e-13, atol=1e-13)
