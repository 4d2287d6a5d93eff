"""The port's ensemble layer (exchange, ReplicaEnsemble, run_sweep) against
the JAX package's.

An f64 JAX subprocess (x64) runs, once per module: ``swap_permutation`` on
fixed energies and ladders with the reference's own uniforms (recorded
beside its permutations), ``apply_exchange`` on random replica batches,
and ``run_sweep`` on a small grid.  The port's ``swap_permutation`` fed the
reference's uniforms (``u=``) must give the reference's permutations and
accept masks; ``apply_exchange`` must agree within 1e-12; ``run_sweep``
must fill the same grid.  Stochastic paths cannot agree draw for draw
(threefry is not Philox), so the rest holds the port to the reference's
own properties: the detailed-balance identity, the exact two-level
stationarity, even/odd neighbor swaps, the exchange counts of a tempering
run, and a batched chunk against per-replica flat steps on the same
generators (bitwise).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.ensemble import protocol
from repro_torch.ensemble.exchange import (apply_exchange, swap_permutation,
                                           swap_probability)
from repro_torch.ensemble.replica import (ReplicaEnsemble, replicate,
                                          spawn_generators)
from repro_torch.ensemble.sweep import run_sweep
from repro_torch.md.integrator import (ForceField, IntegratorConfig,
                                       make_fused_step)
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.neighbor import gather_blocks, refresh_dr
from repro_torch.md.state import SpinLatticeState, init_state, unstack_state
from repro_torch.utils import units
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
# (energies, temperatures, parity) of the swap cases
SWAPS = [([5.0, 1.0, 4.0, 0.5], [10.0, 20.0, 40.0, 80.0], 0),
         ([5.0, 1.0, 4.0, 0.5], [10.0, 20.0, 40.0, 80.0], 1),
         ([-3.0, -3.01, -2.9, -3.2, -3.1], [20.0, 30.0, 45.0, 70.0, 100.0],
          0),
         ([-3.0, -3.01, -2.9, -3.2, -3.1], [20.0, 30.0, 45.0, 70.0, 100.0],
          1),
         ([5.0, 0.0], [10.0, 100.0], 0)]
SWEEP = dict(temps=[30.0, 80.0], fields=[0.0, 5.0], replicas=2, steps=30,
             chunk=10)

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.ensemble.exchange import apply_exchange, swap_permutation
from repro.ensemble.sweep import run_sweep
from repro.md.integrator import ForceField, IntegratorConfig
from repro.md.lattice import simple_cubic
from repro.md.state import SpinLatticeState, init_state

swaps, sweep = eval(sys.argv[2])
out = {}
for i, (e, t, parity) in enumerate(swaps):
    key = jax.random.PRNGKey(100 + i)
    perm, acc = swap_permutation(key, jnp.asarray(e), jnp.asarray(t), parity)
    # swap_permutation's own draw: one uniform per pair tried
    out[f"u{i}"] = np.asarray(jax.random.uniform(key, acc.shape))
    out[f"perm{i}"] = np.asarray(perm)
    out[f"acc{i}"] = np.asarray(acc)
rng = np.random.default_rng(0)
r, n = 4, 5
d = {k: rng.standard_normal((r, n, 3)) for k in ("pos", "vel", "spin", "f",
                                                   "h")}
d["energy"] = rng.standard_normal(r)
d["temps"] = np.asarray([15.0, 30.0, 60.0, 120.0])
states = SpinLatticeState(pos=jnp.asarray(d["pos"]), vel=jnp.asarray(d["vel"]),
                          spin=jnp.asarray(d["spin"]),
                          types=jnp.zeros((r, n), jnp.int32),
                          box=jnp.ones((r, 3)), step=jnp.zeros((r,), jnp.int32))
ffs = ForceField(jnp.asarray(d["energy"]), jnp.asarray(d["f"]),
                 jnp.asarray(d["h"]))
for parity in (0, 1):
    key = jax.random.PRNGKey(200 + parity)
    s2, f2, acc, att = apply_exchange(key, states, ffs,
                                      jnp.asarray(d["temps"]), parity)
    out[f"x{parity}_u"] = np.asarray(jax.random.uniform(key, (att,)))
    out[f"x{parity}_vel"] = np.asarray(s2.vel)
    out[f"x{parity}_pos"] = np.asarray(s2.pos)
    out[f"x{parity}_energy"] = np.asarray(f2.energy)
    out[f"x{parity}_acc"] = int(acc)
out.update({f"in_{k}": v for k, v in d.items()})
lat = simple_cubic()
st = init_state(lat, (4, 4, 1), spin_init="helix_x",
                key=jax.random.PRNGKey(0))
pd = run_sweep(st, HeisenbergDMIModel(d0=0.01),
               IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.1),
               jnp.asarray(lat.masses), jnp.asarray(lat.moments) > 0,
               sweep["temps"], sweep["fields"], n_replicas=sweep["replicas"],
               n_steps=sweep["steps"], key=jax.random.PRNGKey(0), cutoff=5.0,
               capacity=8, chunk=sweep["chunk"], diag_grid=(4, 4))
for k in ("temperatures", "fields", "charge", "charge_abs", "charge_std",
          "magnetization", "pitch", "energy"):
    out[f"pd_{k}"] = np.asarray(getattr(pd, k))
out["pd_n_replicas"] = pd.n_replicas
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("ensemble")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "out.npz"),
         repr((SWAPS, SWEEP))],
        env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.load(d / "out.npz")


# ------------------------------------------------------------- exchange

@pytest.mark.parametrize("case", range(len(SWAPS)))
def test_swap_permutation_with_reference_uniforms(reference, case):
    e, t, parity = SWAPS[case]
    perm, acc = swap_permutation(torch.tensor(e, dtype=F64),
                                 torch.tensor(t, dtype=F64), parity,
                                 u=reference[f"u{case}"])
    assert perm.tolist() == reference[f"perm{case}"].tolist()
    assert acc.tolist() == reference[f"acc{case}"].tolist()


@pytest.mark.parametrize("parity", (0, 1))
def test_apply_exchange_matches_reference(reference, parity):
    d = {k: reference[f"in_{k}"] for k in ("pos", "vel", "spin", "f", "h",
                                           "energy", "temps")}
    r, n = d["pos"].shape[:2]
    states = SpinLatticeState(
        pos=torch.tensor(d["pos"]), vel=torch.tensor(d["vel"]),
        spin=torch.tensor(d["spin"]),
        types=torch.zeros((r, n), dtype=torch.int32),
        box=torch.ones((r, 3), dtype=F64), step=np.zeros(r, np.int64))
    ffs = ForceField(torch.tensor(d["energy"]), torch.tensor(d["f"]),
                     torch.tensor(d["h"]))
    s2, f2, acc, att = apply_exchange(states, ffs, d["temps"], parity,
                                      u=reference[f"x{parity}_u"])
    assert acc == int(reference[f"x{parity}_acc"])
    assert att == len(reference[f"x{parity}_u"])
    for got, key in ((s2.vel, "vel"), (s2.pos, "pos"), (f2.energy, "energy")):
        want = reference[f"x{parity}_{key}"]
        assert np.max(np.abs(got.numpy() - want)) < 1e-12, key


def test_swap_probability_detailed_balance_identity():
    """A(swap)/A(reverse swap) = exp[(bi-bj)(Ei-Ej)]."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        bi, bj = rng.uniform(0.5, 5.0, 2)
        ei, ej = rng.uniform(-2.0, 2.0, 2)
        a_fwd = float(swap_probability(bi, bj, ei, ej))
        a_rev = float(swap_probability(bi, bj, ej, ei))
        np.testing.assert_allclose(a_fwd / a_rev,
                                   np.exp((bi - bj) * (ei - ej)), rtol=1e-12)


def test_exchange_preserves_two_level_product_distribution():
    """Two replicas on a two-level system {0, eps}: the product Boltzmann
    distribution is exactly stationary under the swap move."""
    t1, t2 = 0.6, 2.5  # in units of eps/kB
    b1, b2 = 1.0 / (units.KB * t1), 1.0 / (units.KB * t2)
    levels = np.array([0.0, 1.0 * units.KB])

    def boltz(beta):
        w = np.exp(-beta * levels)
        return w / w.sum()

    pi = np.outer(boltz(b1), boltz(b2))  # pi[x, y] = P(x at 1, y at 2)
    pi_new = np.zeros_like(pi)
    for x in range(2):
        for y in range(2):
            a = float(swap_probability(b1, b2, levels[x], levels[y]))
            pi_new[y, x] += pi[x, y] * a        # swap accepted
            pi_new[x, y] += pi[x, y] * (1 - a)  # rejected
    np.testing.assert_allclose(pi_new, pi, rtol=1e-12)


def test_swap_permutation_is_neighbor_permutation():
    g = torch.Generator().manual_seed(3)
    e = torch.tensor([5.0, 1.0, 4.0, 0.5])   # inverted ladder: swaps likely
    t = torch.tensor([10.0, 20.0, 40.0, 80.0])
    for parity in (0, 1):
        perm, acc = swap_permutation(e, t, parity, generator=g)
        assert sorted(perm.tolist()) == [0, 1, 2, 3]
        assert (perm - torch.arange(4)).abs().max() <= 1
        assert acc.shape == (2 - parity,)
    # hot high-energy / cold low-energy always swaps (A = 1)
    perm, acc = swap_permutation(torch.tensor([5.0, 0.0]),
                                 torch.tensor([10.0, 100.0]), 0, generator=g)
    assert perm.tolist() == [1, 0] and bool(acc[0])
    with pytest.raises(ValueError, match="generator"):
        swap_permutation(e, t, 0)


# ------------------------------------------------------- replica ensemble

def _film(n=4):
    lat = simple_cubic()
    st = init_state(lat, (n, n, 1), spin_init="helix_x", dtype=F64,
                    device="cpu")
    return (lat, HeisenbergDMIModel(d0=0.01), st,
            torch.tensor(lat.masses, dtype=F64),
            torch.tensor(lat.moments) > 0)


def test_batched_chunks_match_sequential_steps():
    """The acceptance-criterion test of the reference: a replica batch's
    chunks match a loop of single-replica steps on the same shared table,
    with the same per-replica generators and schedule rows - here
    bitwise."""
    lat, ham, st, masses, magnetic = _film()
    cfg = IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.1)
    r, nstep, chunk = 3, 20, 10
    temp = protocol.linear(0.0, nstep * cfg.dt, 80.0, 20.0)
    fld = protocol.constant(np.asarray([0.0, 0.0, 3.0], np.float32))
    ens = ReplicaEnsemble(potential=ham, cfg=cfg, states=replicate(st, r),
                          masses=masses, magnetic=magnetic, cutoff=5.0,
                          capacity=8, diag_grid=(4, 4), pitch_bins=4,
                          device="cpu")
    table = ens.table
    ens.run(nstep, spawn_generators(42, r, "cpu"), temperature=temp,
            field=fld, chunk=chunk)
    assert ens._engine.n_rebuilds == 0

    nbh = gather_blocks(st.pos, st.types, table, st.box, reverse=True)

    def compute(nb, spin, types, field):
        return ForceField(*ham.compute(nb, spin, types, field))

    step = make_fused_step(lambda pos, nb: refresh_dr(nb, pos, st.box),
                           compute, cfg, masses, magnetic)
    dt = np.float32(cfg.dt)
    for rr, g in enumerate(spawn_generators(42, r, "cpu")):
        b0 = torch.tensor(fld.at(np.float32(0.0)), dtype=F64)
        s, ff, nb = st, compute(nbh, st.spin, st.types, b0), nbh
        for i in range(nstep):
            # the engine's clock: chunk start plus the in-chunk offset
            t = (np.float32(i // chunk * chunk) * dt
                 + np.float32(i % chunk) * dt)
            s, ff, nb = step(s, ff, nb, g, float(temp.at(t)),
                             torch.tensor(fld.at(t), dtype=F64))
        for k in ("pos", "vel", "spin"):
            assert torch.equal(getattr(s, k), getattr(ens.states, k)[rr]), k


def test_engine_applies_schedule_and_streams_diagnostics():
    lat, ham, st, masses, magnetic = _film(n=6)
    cfg = IntegratorConfig(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.1)
    temp = protocol.linear(0.0, 40 * cfg.dt, 90.0, 30.0)
    ens = ReplicaEnsemble(potential=ham, cfg=cfg, states=replicate(st, 4),
                          masses=masses, magnetic=magnetic, cutoff=5.0,
                          capacity=8, diag_grid=(6, 6), pitch_bins=6,
                          device="cpu")
    tr = ens.run(40, spawn_generators(0, 4, "cpu"), temperature=temp,
                 field=np.asarray([0.0, 0.0, 2.0]), chunk=20)
    assert tr.charge.shape == (2, 4) and tr.temperature.shape == (2, 4)
    assert tr.temperature[-1, 0] == pytest.approx(30.0, abs=1e-3)
    for f in (tr.charge, tr.magnetization, tr.pitch, tr.energy):
        assert np.isfinite(f).all()
    # replicas diverge under independent noise streams
    assert float(ens.states.spin.std(dim=0).max()) > 1e-6


def test_parallel_tempering_runs_and_counts():
    lat, ham, st, masses, magnetic = _film()
    cfg = IntegratorConfig(dt=2e-3, lattice_gamma=5.0, spin_alpha=0.2)
    ladder = protocol.temperature_ladder(20.0, 120.0, 4)
    ens = ReplicaEnsemble(potential=ham, cfg=cfg, states=replicate(st, 4),
                          masses=masses, magnetic=magnetic, cutoff=5.0,
                          capacity=8, diag_grid=(4, 4), pitch_bins=4,
                          device="cpu")
    gens = spawn_generators(1, 4, "cpu")
    tr = ens.run(40, gens, temperature=ladder, chunk=10, exchange_every=1,
                 exchange_generator=torch.Generator().manual_seed(1))
    # parity alternates: 2 pairs (even) + 1 pair (odd) + 2 + 1 = 6 attempts
    assert tr.exchange_attempts == 6
    assert 0 <= tr.exchange_accepts <= tr.exchange_attempts
    with pytest.raises(ValueError):     # a scalar temperature: no ladder
        ens.run(10, gens, temperature=50.0, chunk=10, exchange_every=1,
                exchange_generator=torch.Generator())
    with pytest.raises(ValueError, match="exchange_generator"):
        ens.run(10, gens, temperature=ladder, chunk=10, exchange_every=1)


def test_callback_sees_each_chunk_and_may_nudge():
    lat, ham, st, masses, magnetic = _film()
    ens = ReplicaEnsemble(potential=ham,
                          cfg=IntegratorConfig(dt=2e-3, lattice_gamma=1.0),
                          states=replicate(st, 2), masses=masses,
                          magnetic=magnetic, cutoff=5.0, capacity=8,
                          diag_grid=(4, 4), pitch_bins=4, device="cpu")
    seen = []

    def cb(e):
        seen.append(e.time)
        e.states = e.states._replace(spin=e.states.spin * 1.0)

    ens.run(20, spawn_generators(2, 2, "cpu"), temperature=10.0, chunk=10,
            callback=cb)
    assert seen == pytest.approx([0.02, 0.04])
    row = unstack_state(ens.states, 1)
    assert row.step == 20


# ---------------------------------------------------------------- sweep

def test_sweep_fills_the_reference_grid(reference):
    lat = simple_cubic()
    st = init_state(lat, (4, 4, 1), spin_init="helix_x", device="cpu")
    pd = run_sweep(st, HeisenbergDMIModel(d0=0.01),
                   IntegratorConfig(dt=2e-3, lattice_gamma=2.0,
                                    spin_alpha=0.1),
                   torch.tensor(lat.masses, dtype=torch.float32),
                   torch.tensor(lat.moments) > 0, SWEEP["temps"],
                   SWEEP["fields"], n_replicas=SWEEP["replicas"],
                   n_steps=SWEEP["steps"], seed=0, cutoff=5.0, capacity=8,
                   chunk=SWEEP["chunk"], diag_grid=(4, 4), device="cpu")
    assert pd.n_replicas == int(reference["pd_n_replicas"])
    np.testing.assert_array_equal(pd.temperatures,
                                  reference["pd_temperatures"])
    np.testing.assert_array_equal(pd.fields, reference["pd_fields"])
    for k in ("charge", "charge_abs", "charge_std", "magnetization", "pitch",
              "energy"):
        got, want = getattr(pd, k), reference[f"pd_{k}"]
        assert got.shape == want.shape == (2, 2), k
        assert np.isfinite(got).all(), k
    assert pd.charge_abs.min() >= 0
    # the same film at zero field: the helix's energy scale on both sides
    np.testing.assert_allclose(pd.energy, reference["pd_energy"], rtol=0.05)
    assert pd.summary()
