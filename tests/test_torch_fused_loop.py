"""``tests/test_fused_loop.py``'s 120-step f64 parity scenario in the port.

The reference builds the scenario in an f64 subprocess - simple cubic
3x3x3 at 400 K with random spins, capacity 8, skin 0.2, dt 2 fs, chunk 1
(the half-skin test before every step), for the Heisenberg-DMI model with
two midpoint iterations and for autodiff NEP-SPIN - and runs its fused
``Simulation``.  From the reference's initial state and weights the port
runs its fused ``Simulation`` (the Engine) and its legacy one (host-side
skin test, ``make_step``, ``energy_forces_field``).  The port's fused path
agrees with its legacy path and with the reference's fused path within
1e-9 (absolute, on values of order 1-10), with equal rebuild counts, at
least one of them.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.core.potential import NEPSpinPotential, params_from_jax
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.simulate import Simulation
from repro_torch.md.state import state_from_numpy
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 120
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
CFGS = {"heisenberg": dict(dt=2e-3, midpoint=True, midpoint_iters=2),
        "nep": dict(dt=2e-3)}

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.descriptor import NEPSpinSpec
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.core.potential import NEPSpinPotential, init_params
from repro.md.integrator import IntegratorConfig
from repro.md.lattice import simple_cubic
from repro.md.simulate import Simulation
from repro.md.state import init_state

steps, spec_kw, cfgs = eval(sys.argv[2])
lat = simple_cubic()
st = init_state(lat, (3, 3, 3), temperature=400.0, spin_init="random",
                key=jax.random.PRNGKey(7))
out = {k: np.asarray(getattr(st, k)) for k in ("pos", "vel", "spin",
                                                "types", "box")}
spec = NEPSpinSpec(**spec_kw)
params = init_params(spec, jax.random.PRNGKey(0), dtype=jnp.float64)
out.update({f"param_{i}": np.asarray(x) for i, x in enumerate(params)})
pots = {"heisenberg": HeisenbergDMIModel(d0=0.008, ka=0.001),
        "nep": NEPSpinPotential(spec, params, use_kernel=False)}
for name, pot in pots.items():
    sim = Simulation(potential=pot, cfg=IntegratorConfig(**cfgs[name]),
                     state=st, masses=jnp.asarray(lat.masses),
                     magnetic=jnp.asarray(lat.moments) > 0, cutoff=5.0,
                     capacity=8, skin=0.2)
    sim.run(steps, jax.random.PRNGKey(1), chunk=1)
    for k in ("pos", "vel", "spin"):
        out[f"{name}_{k}"] = np.asarray(getattr(sim.state, k))
    out[f"{name}_rebuilds"] = sim.n_rebuilds
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fused")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "ref.npz"),
         repr((STEPS, SPEC, CFGS))],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = dict(np.load(d / "ref.npz"))

    f64 = torch.float64
    lat = simple_cubic()
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             device="cpu", dtype=f64)
    pots = {"heisenberg": HeisenbergDMIModel(d0=0.008, ka=0.001),
            "nep": NEPSpinPotential(NEPSpinSpec(**SPEC), params)}
    port = {}
    for name, pot in pots.items():
        for fused in (True, False):
            sim = Simulation(
                potential=pot, cfg=IntegratorConfig(**CFGS[name]),
                state=state_from_numpy(*(ref[k] for k in (
                    "pos", "vel", "spin", "types", "box")), dtype=f64,
                    device="cpu"),
                masses=torch.tensor(lat.masses, dtype=f64),
                magnetic=torch.tensor(lat.moments) > 0, cutoff=5.0,
                capacity=8, skin=0.2, fused=fused, device="cpu")
            sim.run(STEPS, chunk=1)
            port[name, fused] = sim
    return ref, port


@pytest.mark.parametrize("pot", ["heisenberg", "nep"])
def test_fused_matches_legacy_f64(runs, pot):
    _, port = runs
    fused, legacy = port[pot, True], port[pot, False]
    assert fused._fused and not legacy._fused
    assert fused.n_rebuilds >= 1
    assert fused.n_rebuilds == legacy.n_rebuilds
    assert fused.state.step == legacy.state.step == STEPS
    for k in ("pos", "vel", "spin"):
        diff = (getattr(fused.state, k) - getattr(legacy.state, k)).abs()
        assert float(diff.max()) < 1e-9, (pot, k)


@pytest.mark.parametrize("pot", ["heisenberg", "nep"])
def test_fused_matches_reference_f64(runs, pot):
    ref, port = runs
    sim = port[pot, True]
    assert sim.n_rebuilds == int(ref[f"{pot}_rebuilds"]) >= 1
    for k in ("pos", "vel", "spin"):
        diff = np.abs(getattr(sim.state, k).numpy() - ref[f"{pot}_{k}"])
        assert diff.max() < 1e-9, (pot, k, diff.max())


def test_chunk_trace_of_the_fused_path(runs):
    _, port = runs
    sim = port["heisenberg", True]
    tr = sim.trace
    assert tr.energy.shape == (STEPS,) and tr.magnetization.shape == (
        STEPS, 3)
    for f in (tr.time, tr.energy, tr.kinetic, tr.magnetization, tr.charge):
        assert np.isfinite(f).all()
    np.testing.assert_allclose(tr.time, 2e-3 * np.arange(1, STEPS + 1),
                               rtol=1e-12)
    assert port["heisenberg", False].trace is None
