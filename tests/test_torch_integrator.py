"""Port Suzuki-Trotter step against the JAX ``make_fused_step``.

One step of B20 2x2x2 with the autograd NEP-SPIN potential at f32 from the
same numpy state and the same weights: NVE with and without the midpoint
iteration (plain and mixed), with a frozen lattice, and one thermostatted
step (lattice Langevin, transverse and
longitudinal spin noise) with the reference's own ``jax.random.normal``
draws for its five noise streams injected through ``noise=``.  Everything
agrees within 2e-5 of each quantity's max.  Plus: |S| is conserved to f64
roundoff over NVE steps, and a thermostatted step without a generator or
pre-drawn noise raises.  And the reference's two statistical tests of the
thermostats: one spin in a field samples the Langevin function through
``make_step``, and a Langevin lattice equilibrates to its target.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import descriptor as jdesc
from repro.core import potential as jpot
from repro.md import integrator as jint
from repro.md import neighbor as jnb
from repro.md.state import SpinLatticeState as JState
from repro_torch.core import descriptor as tdesc
from repro_torch.core import potential as tpot
from repro_torch.md import integrator as tint
from repro_torch.md import neighbor as tnb
from repro_torch.md.lattice import b20_fege
from repro_torch.md.state import SpinLatticeState, state_from_numpy
from repro_torch.utils import units
from torch_one_thread import one_torch_thread  # noqa: F401

SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6, hidden=16)
FIELD = (0.0, 0.1, 0.3)
MOM = np.asarray([1.16, 0.0], np.float32)


def _arrays(seed=0, dtype=np.float32):
    lat = b20_fege()
    pos, types, box = lat.supercell(2, 2, 2)
    rng = np.random.default_rng(seed)
    pos = np.mod(pos + 0.05 * rng.standard_normal(pos.shape), box)
    sigma = np.sqrt(units.KB * 300.0 / (lat.masses[types] * units.MVV2E))
    vel = sigma[:, None] * rng.standard_normal(pos.shape)
    spin = rng.standard_normal(pos.shape)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    spin[lat.moments[types] == 0] = 0.0
    return lat, dict(pos=pos.astype(dtype), vel=vel.astype(dtype),
                     spin=spin.astype(dtype), types=types,
                     box=box.astype(dtype))


def _jax_step(cfg, arrays, lat, jparams, key):
    spec = jdesc.NEPSpinSpec(**SPEC)
    st = JState(pos=jnp.asarray(arrays["pos"]), vel=jnp.asarray(arrays["vel"]),
                spin=jnp.asarray(arrays["spin"]),
                types=jnp.asarray(arrays["types"], jnp.int32),
                box=jnp.asarray(arrays["box"]), step=jnp.asarray(0, jnp.int32))
    mom, field = jnp.asarray(MOM), jnp.asarray(FIELD, jnp.float32)
    tab = jnb.dense_neighbor_table(st.pos, st.box, 5.0, 48)
    nbh = jnb.gather_blocks(st.pos, st.types, tab, st.box)

    def compute(nb, s, t, f):
        return jint.ForceField(*jpot.compute(spec, jparams, nb, s, t, f, mom))

    step = jint.make_fused_step(
        gather=lambda pos, nb: jnb.refresh_dr(nb, pos, st.box),
        compute=compute, cfg=cfg,
        masses=jnp.asarray(lat.masses, jnp.float32),
        magnetic=jnp.asarray(lat.moments) > 0)
    ff = compute(nbh, st.spin, st.types, field)
    st, ff, _ = step(st, ff, nbh, key, None, field)
    return st, ff, tab


def _port_step(cfg, arrays, lat, jparams, jtab, noise=None):
    spec = tdesc.NEPSpinSpec(**SPEC)
    params = tpot.params_from_jax([np.asarray(x) for x in jparams],
                                  device="cpu", dtype=torch.float32)
    st = state_from_numpy(**arrays, dtype=torch.float32, device="cpu")
    mom = torch.as_tensor(MOM)
    tab = tnb.NeighborTable(idx=torch.as_tensor(np.array(jtab.idx)),
                            mask=torch.as_tensor(np.array(jtab.mask)),
                            r0=st.pos, cutoff=5.5)
    nbh = tnb.gather_blocks(st.pos, st.types, tab, st.box)

    def compute(nb, s, t, f):
        return tint.ForceField(*tpot.compute(spec, params, nb, s, t, f, mom))

    step = tint.make_fused_step(
        gather=lambda pos, nb: tnb.refresh_dr(nb, pos, st.box),
        compute=compute, cfg=cfg,
        masses=torch.as_tensor(lat.masses, dtype=torch.float32),
        magnetic=torch.as_tensor(lat.moments) > 0)
    ff = compute(nbh, st.spin, st.types, FIELD)
    st, ff, _ = step(st, ff, nbh, None, None, FIELD, noise=noise)
    return st, ff


def _close(got, want, rtol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-9)
    assert float(np.abs(got - want).max()) / scale < rtol


def _compare(jst, jff, tst, tff):
    for f in ("pos", "vel", "spin"):
        _close(getattr(tst, f), getattr(jst, f))
    assert tst.step == int(jst.step) == 1
    _close(tff.energy, jff.energy)
    _close(tff.force, jff.force)
    _close(tff.field, jff.field)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(midpoint=True, midpoint_iters=3),
    dict(midpoint=True, midpoint_iters=2, midpoint_mixing=0.6),
    dict(frozen_lattice=True),
])
def test_nve_step_matches_jax(variant):
    lat, arrays = _arrays(seed=1)
    jparams = jpot.init_params(jdesc.NEPSpinSpec(**SPEC),
                               jax.random.PRNGKey(3), dtype=jnp.float32)
    kw = dict(dt=2e-3, **variant)
    jst, jff, jtab = _jax_step(jint.IntegratorConfig(**kw), arrays, lat,
                               jparams, jax.random.PRNGKey(0))
    tst, tff = _port_step(tint.IntegratorConfig(**kw), arrays, lat, jparams,
                          jtab)
    _compare(jst, jff, tst, tff)


def test_stochastic_step_with_injected_jax_noise():
    lat, arrays = _arrays(seed=2)
    jparams = jpot.init_params(jdesc.NEPSpinSpec(**SPEC),
                               jax.random.PRNGKey(5), dtype=jnp.float32)
    kw = dict(dt=2e-3, temperature=300.0, lattice_gamma=2.0, spin_alpha=0.1,
              spin_longitudinal=0.5)
    key = jax.random.PRNGKey(11)
    jst, jff, jtab = _jax_step(jint.IntegratorConfig(**kw), arrays, lat,
                               jparams, key)
    # the reference's draws: step key split five ways, one normal each
    n = arrays["pos"].shape[0]
    subkeys = jax.random.split(key, 5)
    shapes = {"k1": (n, 3), "k2": (n, 3), "k3": (n, 3), "k4": (n, 1),
              "k5": (n, 3)}
    noise = {name: torch.as_tensor(np.array(jax.random.normal(
        k, shapes[name], jnp.float32))) for name, k in zip(tint.NOISE_KEYS,
                                                          subkeys)}
    tst, tff = _port_step(tint.IntegratorConfig(**kw), arrays, lat, jparams,
                          jtab, noise=noise)
    _compare(jst, jff, tst, tff)
    with pytest.raises(ValueError, match="Generator"):
        _port_step(tint.IntegratorConfig(**kw), arrays, lat, jparams, jtab)


def test_spin_norm_conserved_f64():
    lat, arrays = _arrays(seed=3, dtype=np.float64)
    spec = tdesc.NEPSpinSpec(**SPEC)
    f64 = torch.float64
    params = tpot.init_params(spec, torch.Generator().manual_seed(0),
                              dtype=f64, device="cpu")
    st = state_from_numpy(**arrays, dtype=f64, device="cpu")
    pot = tpot.NEPSpinPotential(spec, params, torch.as_tensor(MOM, dtype=f64),
                                use_kernel=True)
    tab = tnb.dense_neighbor_table(st.pos, st.box, 5.0, 48)
    nbh = tnb.gather_blocks(st.pos, st.types, tab, st.box)

    def compute(nb, s, t, f):
        return tint.ForceField(*pot.compute(nb, s, t, f))

    mag = torch.as_tensor(lat.moments)[st.types.long()] > 0
    for cfg in (tint.IntegratorConfig(dt=2e-3),
                dataclasses.replace(tint.IntegratorConfig(dt=2e-3),
                                    midpoint=True)):
        step = tint.make_fused_step(
            gather=lambda pos, nb: tnb.refresh_dr(nb, pos, st.box),
            compute=compute, cfg=cfg,
            masses=torch.as_tensor(lat.masses, dtype=f64),
            magnetic=torch.as_tensor(lat.moments) > 0)
        s, ff, nb = st, compute(nbh, st.spin, st.types, FIELD), nbh
        for _ in range(5):
            s, ff, nb = step(s, ff, nb, None, None, FIELD)
        norm = torch.linalg.norm(s.spin, dim=-1)
        assert float(torch.abs(norm[mag] - 1.0).max()) < 1e-12
        assert float(norm[~mag].abs().max()) == 0.0
        assert s.step == 5


# ---------------------------------------------------------------------------
# statistical tests of the thermostats (ports of tests/test_integrator.py)
# ---------------------------------------------------------------------------

def test_single_spin_boltzmann():
    """One spin in a field: <cos theta> matches the Langevin function
    L(x) = coth x - 1/x, through the legacy ``make_step`` (the sLLG
    fluctuation-dissipation discretization)."""
    t_k, b_z = 50.0, 10.0     # K, Tesla
    x = 1.16 * units.MU_B * b_z / (units.KB * t_k)
    expect = 1.0 / np.tanh(x) - 1.0 / x
    cfg = tint.IntegratorConfig(dt=2e-3, temperature=t_k, spin_alpha=0.5,
                                moment=1.16)
    field_e = 1.16 * units.MU_B * b_z   # eV per unit spin

    def evaluate(pos, spin):
        return tint.ForceField(
            energy=torch.zeros(()), force=torch.zeros_like(pos),
            field=torch.tensor([[0.0, 0.0, field_e]]).expand(pos.shape[0],
                                                              3))

    step = tint.make_step(evaluate, cfg, torch.tensor([55.0]),
                          torch.tensor([True]))
    n = 256   # independent spins sampled in parallel
    state = SpinLatticeState(
        pos=torch.zeros((n, 3)), vel=torch.zeros((n, 3)),
        spin=torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1),
        types=torch.zeros((n,), dtype=torch.int32),
        box=torch.full((3,), 100.0))
    ff = evaluate(state.pos, state.spin)
    gen = torch.Generator().manual_seed(0)
    sz = []
    for i in range(3000):
        state, ff = step(state, ff, gen)
        if i >= 1000:     # discard burn-in
            sz.append(state.spin[:, 2].mean())
    got = float(torch.stack(sz).mean())
    assert abs(got - expect) < 0.05, f"<cos> {got} vs Langevin {expect}"


def test_langevin_thermostat_equilibrates():
    """A 240 K lattice under a 120 K Langevin thermostat reaches ~120 K in
    400 steps (the fused Simulation, Heisenberg-DMI)."""
    from repro_torch.core.hamiltonian import HeisenbergDMIModel
    from repro_torch.md.lattice import simple_cubic
    from repro_torch.md.simulate import Simulation
    from repro_torch.md.state import init_state, temperature_of
    lat = simple_cubic()
    st = init_state(lat, (4, 4, 4), generator=torch.Generator()
                    .manual_seed(3), temperature=240.0, spin_init="random",
                    device="cpu")
    cfg = tint.IntegratorConfig(dt=2e-3, temperature=120.0,
                                lattice_gamma=5.0, spin_alpha=0.1)
    sim = Simulation(potential=HeisenbergDMIModel(d0=0.004, ka=0.001),
                     cfg=cfg, state=st,
                     masses=torch.tensor(lat.masses, dtype=torch.float32),
                     magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                     capacity=8, device="cpu")
    sim.run(400, torch.Generator().manual_seed(3), chunk=100)
    t = float(temperature_of(sim.state, torch.tensor(lat.masses,
                                                     dtype=torch.float32)))
    assert 70.0 < t < 180.0, f"lattice T {t} K (target 120)"
