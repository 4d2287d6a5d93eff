"""The port's NEP-SPIN training (``repro_torch.core.training``) against the
JAX package's, and its own statistical fit.

One f64 JAX subprocess (x64) per module, on B20 2x2x2 (64 atoms) with
``benchmarks/accuracy.py``'s oracle:

* ``generate_dataset`` (6 configurations) and the standard draws it made
  (the same key splits, written out);
* ``init_params`` and ``calibrate_scale``; ``loss_fn`` and its gradient
  (``jax.value_and_grad``) at the calibrated parameters;
* five ``fit_adam`` steps and three ``fit_snes`` generations (population
  4) from those parameters, with the half draws ``snes_ask`` made.

The port, at f64 on the CPU: the configurations from the reference's draws
and their oracle labels, the calibration, the loss and every gradient leaf
(through ``create_graph``), and the SNES fitnesses and mean, all within
1e-9; the Adam steps within 1e-7 (loss) and 5e-7 (parameters), as the
reference's f32 AdamW math allows (see that test).  Then
``tests/test_system.py``'s scenario with its bars (the fit converges, F and H RMSE under 0.35x their
label scales, 100 thermostatted MD steps with the fitted potential stay
finite with Fe |S| in (0.3, 2)), and the launchers at smoke size.
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
from repro_torch.core.potential import NEPSpinParams, params_from_jax
from repro_torch.core.training import (Dataset, calibrate_scale, fit_adam,
                                       fit_snes, generate_dataset,
                                       loss_and_grad, rmse_metrics)
from repro_torch.md.lattice import b20_fege
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
ORACLE = dict(r0=2.45, morse_de=0.4, morse_alpha=1.6, d0=0.005, kpd=0.001)
SPEC = dict(l_max=2, n_ang=2, n_rad=4, n_spin=3, basis_size=6)
N_CONFIGS, POP, ADAM_STEPS, SNES_GENS = 6, 4, 5, 3

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.descriptor import NEPSpinSpec
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.core.potential import init_params
from repro.core.training import (calibrate_scale, fit_adam, fit_snes,
                                 generate_dataset, loss_fn)
from repro.md.lattice import b20_fege

oracle_kw, spec_kw, n_configs, pop, adam_steps, snes_gens = eval(sys.argv[2])
spec = NEPSpinSpec(**spec_kw)
key = jax.random.PRNGKey(0)
ds = generate_dataset(HeisenbergDMIModel(**oracle_kw), b20_fege(), (2, 2, 2),
                      n_configs, key)
out = {k: np.asarray(v) for k, v in ds._asdict().items()}
n = ds.pos.shape[1]
draws = {"disp": [], "axis": [], "cone": [], "fluct": []}
for k in jax.random.split(key, n_configs):
    kd, ks, km, kc = jax.random.split(k, 4)
    draws["disp"].append(jax.random.normal(kd, (n, 3)))
    draws["axis"].append(jax.random.normal(ks, (n, 3)))
    draws["cone"].append(jax.random.uniform(kc, (n, 1)))
    draws["fluct"].append(jax.random.normal(km, (n, 1)))
out.update({f"draw_{k}": np.stack([np.asarray(x) for x in v])
            for k, v in draws.items()})
p0 = init_params(spec, jax.random.PRNGKey(1), dtype=jnp.float64)
pc = calibrate_scale(spec, p0, ds)
loss, grads = jax.value_and_grad(lambda p: loss_fn(spec, p, ds))(pc)
out["loss"] = np.asarray(loss)
for i, (a, b, g) in enumerate(zip(p0, pc, grads)):
    out[f"p0_{i}"], out[f"pc_{i}"], out[f"g_{i}"] = (
        np.asarray(a), np.asarray(b), np.asarray(g))
pa, hist = fit_adam(spec, ds, jax.random.PRNGKey(2), steps=adam_steps,
                    params=p0)
out["adam_hist"] = np.asarray(hist)
for i, x in enumerate(pa):
    out[f"adam_{i}"] = np.asarray(x)
# fit_snes's draws: its key splits and snes_ask's, replayed
k = jax.random.PRNGKey(5)
leaves = jax.tree_util.tree_leaves(pc)
for g in range(snes_gens):
    k, kg = jax.random.split(k)
    for i, (kk, p) in enumerate(zip(jax.random.split(kg, len(leaves)),
                                    leaves)):
        out[f"snes_noise_{g}_{i}"] = np.asarray(
            jax.random.normal(kk, (pop // 2, *p.shape), p.dtype))
ps, shist = fit_snes(spec, ds, jax.random.PRNGKey(5), generations=snes_gens,
                     popsize=pop, params=p0)
out["snes_hist"] = np.asarray(shist)
for i, x in enumerate(ps):
    out[f"snes_{i}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("training")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "out.npz"),
         repr((ORACLE, SPEC, N_CONFIGS, POP, ADAM_STEPS, SNES_GENS))],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(d / "out.npz")
    t = lambda k: torch.tensor(ref[k])  # noqa: E731
    ds = Dataset(pos=t("pos"), spin=t("spin"),
                 types=t("types").to(torch.int32), box=t("box"),
                 e_ref=t("e_ref"), f_ref=t("f_ref"), h_ref=t("h_ref"))
    leaves = lambda tag: params_from_jax(  # noqa: E731
        [ref[f"{tag}_{i}"] for i in range(8)], device="cpu", dtype=F64)
    return dict(ref=ref, ds=ds, p0=leaves("p0"), pc=leaves("pc"),
                spec=NEPSpinSpec(**SPEC))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def test_generate_dataset_from_reference_draws(reference):
    """The reference's draws through the port's sampling: positions and
    spins within 1e-12, the oracle's E/F/H labels within 1e-9."""
    ref = reference["ref"]
    draws = {k: torch.tensor(ref[f"draw_{k}"])
             for k in ("disp", "axis", "cone", "fluct")}
    ds = generate_dataset(HeisenbergDMIModel(**ORACLE), b20_fege(),
                          (2, 2, 2), N_CONFIGS, draws=draws, dtype=F64,
                          device="cpu")
    assert ds.pos.shape == (N_CONFIGS, 64, 3)
    for k in ("pos", "spin", "box"):
        assert _rel(getattr(ds, k).numpy(), ref[k]) < 1e-12, k
    assert np.array_equal(ds.types.numpy(), ref["types"])
    for k in ("e_ref", "f_ref", "h_ref"):
        assert _rel(getattr(ds, k).numpy(), ref[k]) < 1e-9, k


def test_generate_dataset_draws_from_a_generator():
    """Without caller draws the configurations come from the generator:
    reproducible from a seed, Ge spins zero, Fe |S| near 1."""
    args = (HeisenbergDMIModel(**ORACLE), b20_fege(), (2, 2, 2), 3)
    a, b = (generate_dataset(*args, torch.Generator().manual_seed(4),
                             device="cpu") for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    fe = a.types == 0
    assert torch.all(a.spin[:, ~fe] == 0)
    smag = torch.linalg.norm(a.spin[:, fe], dim=-1)
    assert 0.5 < float(smag.min()) and float(smag.max()) < 1.5


def test_calibrate_scale_matches_reference(reference):
    pc = calibrate_scale(reference["spec"], reference["p0"],
                         reference["ds"])
    assert _rel(pc.q_scale.numpy(), reference["ref"]["pc_7"]) < 1e-9


def test_loss_and_gradient_match_reference(reference):
    """The loss (E per atom, F, H) and its gradient in every parameter leaf
    through the ``create_graph`` autograd evaluation, within 1e-9."""
    ref = reference["ref"]
    loss, grads = loss_and_grad(reference["spec"], reference["pc"],
                                reference["ds"])
    assert abs(float(loss) - float(ref["loss"])) < 1e-9 * float(ref["loss"])
    for i, (name, g) in enumerate(zip(NEPSpinParams._fields, grads)):
        assert _rel(g.numpy(), ref[f"g_{i}"]) < 1e-9, name


def test_fit_adam_five_steps_match_reference(reference):
    """Five Adam steps (calibration, weight decay 0, clip 10) from the
    reference's initial parameters.  The first loss is the f64 evaluation
    and agrees within 1e-9.  The reference's AdamW does its math in f32,
    and the clip binds here (gradient norms above 10): the f32 sum of
    squares behind the clip scale is added in another order by XLA than by
    torch (tests/test_torch_optimizer.py), so every later step carries a
    difference of a few f32 ulps: the loss history agrees within 1e-7
    (measured 1.8e-8) and every parameter leaf within 5e-7 (measured at
    most 1.6e-7)."""
    ref = reference["ref"]
    params, hist = fit_adam(reference["spec"], reference["ds"],
                            steps=ADAM_STEPS, params=reference["p0"])
    assert abs(hist[0] - ref["adam_hist"][0]) < 1e-9 * ref["adam_hist"][0]
    assert _rel(hist, ref["adam_hist"]) < 1e-7
    assert hist[-1] < 0.5 * hist[0]
    for i, name in enumerate(NEPSpinParams._fields):
        assert _rel(params[i].numpy(), ref[f"adam_{i}"]) < 5e-7, name


def test_fit_snes_matches_reference_with_its_noise(reference):
    """Three SNES generations fed the reference's half draws: the best
    fitness of each generation and the final mean within 1e-9."""
    ref = reference["ref"]
    noise = [[torch.tensor(ref[f"snes_noise_{g}_{i}"]) for i in range(8)]
             for g in range(SNES_GENS)]
    mean, hist = fit_snes(reference["spec"], reference["ds"],
                          generations=SNES_GENS, popsize=POP,
                          params=reference["p0"], noise=noise)
    assert _rel(hist, ref["snes_hist"]) < 1e-9
    for i, name in enumerate(NEPSpinParams._fields):
        assert _rel(mean[i].numpy(), ref[f"snes_{i}"]) < 1e-9, name


# ---------------------------------------------------------------------------
# tests/test_system.py's scenario, in the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted():
    g = torch.Generator().manual_seed(0)
    lat = b20_fege()
    spec = NEPSpinSpec(**SPEC)
    ds = generate_dataset(HeisenbergDMIModel(r0=2.45, morse_de=0.4,
                                             morse_alpha=1.6, d0=0.005),
                          lat, (2, 2, 2), 16, g, device="cpu")
    params, hist = fit_adam(spec, ds, g, steps=120)
    return lat, spec, params, ds, hist


def test_nep_fit_converges(fitted):
    *_, hist = fitted
    assert hist[-1] < 0.25 * hist[0], f"{hist[0]} -> {hist[-1]}"


def test_nep_accuracy_table(fitted):
    """RMSEs against the oracle small relative to the label scales."""
    lat, spec, params, ds, _ = fitted
    m = rmse_metrics(spec, params, ds)
    assert m["f_rmse"] < 0.35 * float(torch.sqrt(torch.mean(ds.f_ref ** 2)))
    assert m["h_rmse"] < 0.35 * float(torch.sqrt(torch.mean(ds.h_ref ** 2)))


def test_md_with_fitted_potential_is_stable(fitted):
    """100 thermostatted steps with the fitted surrogate (the fused Engine
    through the autograd evaluation): finite, Fe |S| bounded."""
    from repro_torch.core.potential import NEPSpinPotential
    from repro_torch.md.integrator import IntegratorConfig
    from repro_torch.md.simulate import Simulation
    from repro_torch.md.state import init_state
    lat, spec, params, _, _ = fitted
    g = torch.Generator().manual_seed(1)
    st = init_state(lat, (2, 2, 2), generator=g, temperature=80.0,
                    spin_init="helix_x", device="cpu")
    sim = Simulation(
        potential=NEPSpinPotential(spec, params, torch.tensor(lat.moments,
                                                              dtype=torch.float32)),
        cfg=IntegratorConfig(dt=1e-3, temperature=80.0, lattice_gamma=2.0,
                             spin_alpha=0.05, spin_longitudinal=0.02),
        state=st, masses=torch.tensor(lat.masses, dtype=torch.float32),
        magnetic=torch.tensor(lat.moments) > 0, cutoff=spec.cutoff,
        capacity=64, field=torch.tensor([0.0, 0.0, 0.05]), device="cpu")
    sim.run(100, torch.Generator().manual_seed(2), chunk=25)
    for k in ("pos", "vel", "spin"):
        assert bool(torch.isfinite(getattr(sim.state, k)).all()), k
    norms = torch.linalg.norm(sim.state.spin, dim=-1)[sim.state.types == 0]
    assert float(norms.min()) > 0.3 and float(norms.max()) < 2.0


# ---------------------------------------------------------------------------
# the launchers at smoke size
# ---------------------------------------------------------------------------

def test_train_md_fits_then_runs_md():
    """launch/train.py's train_md at smoke size: a few Adam steps, then
    100 MD steps on 3^3 B20 cells with the fitted weights (on the CPU the
    K1/K2 route is off by default)."""
    from repro_torch.launch.train import main
    out = main(["--arch", "fege-spinlattice", "--device", "cpu", "--cells",
                "3", "--fit-steps", "5", "--steps", "100"])
    assert out["loss_last"] < out["loss_first"]
    assert not out["use_kernel"] and out["n_atoms"] == 216
    assert len(out["chunk_temperatures"]) == 4 and len(out["rows"]) == 2
    assert np.isfinite(out["pitch"]) and np.isfinite(
        out["chunk_temperatures"]).all()


def test_accuracy_table_rows(capsys):
    """launch/accuracy.py at 3 Adam steps: three CSV rows; the classical
    scan recovers the oracle's J0 (the grid holds 0.0168, near its 0.0166)
    and the spin-free NEP's field error stays at the label scale."""
    from repro_torch.launch import accuracy
    out = accuracy.main(["--device", "cpu", "--steps", "3"])
    rows = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("accuracy/")]
    assert [r.split(",")[0] for r in rows] == [
        "accuracy/nepspin", "accuracy/nep-nospin", "accuracy/classical-fit"]
    assert out["classical-fit"]["j0"] == pytest.approx(0.0168, abs=1e-4)
    h_scale = float(torch.sqrt(torch.mean(out["val"].h_ref ** 2)))
    assert out["nep-nospin"]["h_rmse"] > 0.9 * h_scale


def test_quickstart_selects_a_pitch():
    """launch/quickstart.py at 5 Adam steps: four helix energies from one
    Engine, finite, and a validation RMSE."""
    from repro_torch.launch.quickstart import main
    out = main(["--device", "cpu", "--steps", "5"])
    assert sorted(out["energies"]) == [1, 2, 3, 4]
    assert all(np.isfinite(e) for e in out["energies"].values())
    assert out["best"] in (1, 2, 3, 4) and out["validation"]["f_rmse"] > 0
