"""The port's job server against the reference's.

The reference's SOLO server (1 slot) runs in one f64 JAX subprocess (a
module fixture) on four jobs at T = 0 - three Heisenberg-DMI jobs on
simple cubic 4x4x4 with the CLI fleet's field protocols (none, a constant
5 T along z, and field cooling's 10 T schedule) and one NEP-SPIN job on
B20 2x2x2 (the smoke spec, weights from the reference's ``init_params``)
in 0.5 T - and writes the streamed rows and final spins to an ``.npz``.
The port's solo server runs the same jobs at f64 on the CPU from the same
numpy states and weights: streams and final spins agree within 1e-9 of
their scale (T = 0: the thermostats draw noise but scale it by zero, so
the runs are deterministic).  Packed reference runs are never the
oracle: the reference's packed parity fails on this tree (ROADMAP §3);
the port's packed runs are held bitwise to its own solo runs in
``tests/test_torch_serve.py``.

Also: ``journal_report`` and the serving lines of ``runlog_report`` of
both packages render the same journal and runlog (a journaled server
with a requeued eviction, a deadline, a cancellation, a priority shed
and a recovery, written by the port) line for line; and the reference's
``potential_digest``, which digests ``repr``, gives one bucket to two
weight sets that differ in an entry ``repr`` elides, where the port's
digest of the parameter bytes gives two.
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
from repro_torch.ensemble import protocol
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import b20_fege, simple_cubic
from repro_torch.md.state import state_from_numpy
from repro_torch.serve import (RequeuePolicy, ServeConfig, SimJob,
                               SimServer)
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CHUNK, OBS_EVERY, DT = 10, 5, 2e-3
HEIS_STEPS = (20, 30, 20)
NEP_STEPS = 20
NEP_SPEC = dict(cutoff=5.0, basis_size=6, n_rad=4, n_ang=2, l_max=2,
                n_spin=2, hidden=16)
NEP_FIELD = (0.0, 0.0, 0.5)
BAR = 1e-9

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.core.descriptor import NEPSpinSpec
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.core.potential import NEPSpinPotential, init_params
from repro.ensemble import protocol
from repro.md.integrator import IntegratorConfig
from repro.md.state import SpinLatticeState
from repro.serve import ServeConfig, SimJob, SimServer

(chunk, obs_every, dt, heis_steps, nep_steps, nep_spec, nep_field,
 tmp) = eval(sys.argv[3])
d = np.load(sys.argv[1])


def state(tag):
    return SpinLatticeState(
        pos=jnp.asarray(d[tag + "pos"]), vel=jnp.asarray(d[tag + "vel"]),
        spin=jnp.asarray(d[tag + "spin"]),
        types=jnp.asarray(d[tag + "types"], jnp.int32),
        box=jnp.asarray(d[tag + "box"]), step=jnp.asarray(0, jnp.int32))


heis_cfg = IntegratorConfig(dt=dt, spin_alpha=0.05, frozen_lattice=True)
fields = [None, np.asarray([0.0, 0.0, 5.0]),
          protocol.field_cooling(300.0, 50.0, 10.0, t_hold=chunk * dt,
                                 t_ramp=chunk * dt)[1]]
jobs = [SimJob(state=state("h_"), potential=HeisenbergDMIModel(d0=0.01),
               cfg=heis_cfg, masses=d["h_masses"], magnetic=d["h_magnetic"],
               steps=s, temperature=0.0, field=f, obs_every=obs_every,
               seed=100 + i, tenant="alice")
        for i, (s, f) in enumerate(zip(heis_steps, fields))]
spec = NEPSpinSpec(**nep_spec)
params = init_params(spec, jax.random.PRNGKey(4), dtype=jnp.float64)
pot = NEPSpinPotential(spec, params, moments=jnp.asarray([1.16, 0.0]))
jobs.append(SimJob(state=state("n_"), potential=pot,
                   cfg=IntegratorConfig(dt=dt, spin_alpha=0.1,
                                        frozen_lattice=True),
                   masses=d["n_masses"], magnetic=d["n_magnetic"],
                   steps=nep_steps, cutoff=nep_spec["cutoff"], capacity=64,
                   skin=0.5, field=np.asarray(nep_field), obs_every=obs_every,
                   seed=7, tenant="bob"))
srv = SimServer(ServeConfig(runlog=tmp + "/ref.jsonl", workdir=tmp + "/ref",
                            slots=1, chunk=chunk))
hs = [srv.submit(j) for j in jobs]
srv.drain()
out = {f"param_{i}": np.asarray(x) for i, x in enumerate(params)}
for i, h in enumerate(hs):
    assert h.status == "done", (h.status, h.error)
    out[f"job{i}_times"] = h.times
    for k, v in h.observables.items():
        out[f"job{i}_{k}"] = v
    out[f"job{i}_spin"] = np.asarray(h.final_state.spin)
    out[f"job{i}_step"] = int(h.final_state.step)
np.savez(sys.argv[2], **out)
"""


def _heis_state():
    lat = simple_cubic()
    pos, types, box = lat.supercell(4, 4, 4)
    phase = 2.0 * np.pi / box[0] * pos[:, 0]
    spin = np.stack([np.zeros_like(phase), np.cos(phase), np.sin(phase)], -1)
    return lat, dict(pos=pos, vel=np.zeros_like(pos), spin=spin,
                     types=types, box=box)


def _nep_state():
    lat = b20_fege()
    pos, types, box = lat.supercell(2, 2, 2)
    rng = np.random.default_rng(5)
    spin = rng.standard_normal(pos.shape)
    spin /= np.linalg.norm(spin, axis=-1, keepdims=True)
    spin[lat.moments[types] == 0] = 0.0
    return lat, dict(pos=pos, vel=np.zeros_like(pos), spin=spin,
                     types=types, box=box)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ref")
    hlat, hs = _heis_state()
    nlat, ns = _nep_state()
    arrays = {**{"h_" + k: v for k, v in hs.items()},
              **{"n_" + k: v for k, v in ns.items()},
              "h_masses": np.asarray(hlat.masses),
              "h_magnetic": np.asarray(hlat.moments) > 0,
              "n_masses": np.asarray(nlat.masses),
              "n_magnetic": np.asarray(nlat.moments) > 0}
    np.savez(tmp / "in.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": XLA_ONE_THREAD}
    args = repr((CHUNK, OBS_EVERY, DT, HEIS_STEPS, NEP_STEPS, NEP_SPEC,
                 NEP_FIELD, str(tmp)))
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT,
                        str(tmp / "in.npz"), str(tmp / "out.npz"), args],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(tmp / "out.npz")), arrays, tmp


def _port_solo(ref, arrays, tmp):
    """The port's solo server on the reference's jobs, f64 on the CPU."""
    def state(tag):
        return state_from_numpy(*(arrays[tag + k] for k in
                                  ("pos", "vel", "spin", "types", "box")),
                                dtype=torch.float64, device="cpu")

    heis_cfg = IntegratorConfig(dt=DT, spin_alpha=0.05, frozen_lattice=True)
    fields = [None, np.asarray([0.0, 0.0, 5.0]),
              protocol.field_cooling(300.0, 50.0, 10.0, t_hold=CHUNK * DT,
                                     t_ramp=CHUNK * DT)[1]]
    jobs = [SimJob(state=state("h_"), potential=HeisenbergDMIModel(d0=0.01),
                   cfg=heis_cfg, masses=arrays["h_masses"],
                   magnetic=arrays["h_magnetic"], steps=s, temperature=0.0,
                   field=f, obs_every=OBS_EVERY, seed=100 + i,
                   tenant="alice")
            for i, (s, f) in enumerate(zip(HEIS_STEPS, fields))]
    spec = NEPSpinSpec(**NEP_SPEC)
    params = params_from_jax([ref[f"param_{i}"] for i in range(8)],
                             dtype=torch.float64, device="cpu")
    pot = NEPSpinPotential(spec, params,
                           torch.tensor([1.16, 0.0], dtype=torch.float64),
                           use_kernel=True)
    jobs.append(SimJob(state=state("n_"), potential=pot,
                       cfg=IntegratorConfig(dt=DT, spin_alpha=0.1,
                                            frozen_lattice=True),
                       masses=arrays["n_masses"],
                       magnetic=arrays["n_magnetic"], steps=NEP_STEPS,
                       cutoff=NEP_SPEC["cutoff"], capacity=64, skin=0.5,
                       field=np.asarray(NEP_FIELD), obs_every=OBS_EVERY,
                       seed=7, tenant="bob"))
    srv = SimServer(ServeConfig(runlog=str(tmp / "port.jsonl"),
                                workdir=str(tmp / "port"), slots=1,
                                chunk=CHUNK))
    hs = [srv.submit(j) for j in jobs]
    srv.drain()
    return hs


def _close(got, want, what, scale=None):
    """Within BAR of ``scale`` (default the reference's max |value|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err < BAR, (what, err)


def test_solo_server_matches_the_reference(reference):
    """Heisenberg-DMI and NEP-SPIN jobs: streamed rows (every
    ``obs_every`` steps, on each job's own clock) and final spins within
    1e-9 of the reference's solo server at f64."""
    ref, arrays, tmp = reference
    hs = _port_solo(ref, arrays, tmp)
    assert len(hs) == 4
    for i, h in enumerate(hs):
        assert h.status == "done", h.error
        np.testing.assert_array_equal(h.times, ref[f"job{i}_times"])
        _close(h.observables["energy"], ref[f"job{i}_energy"],
               f"job{i} energy")
        # the helix's in-plane magnetization is 0 up to roundoff: held to
        # the scale of a unit spin
        _close(h.observables["magnetization"],
               ref[f"job{i}_magnetization"], f"job{i} magnetization", 1.0)
        _close(h.final_state.spin.numpy(), ref[f"job{i}_spin"],
               f"job{i} spin")
        assert h.final_state.step == int(ref[f"job{i}_step"])


@pytest.fixture(scope="module")
def serving_logs(tmp_path_factory):
    """A journaled port server with a requeued and struck-out eviction, a
    deadline, a cancellation, a priority shed, then a crash after two
    ticks and a recovery: its runlog and journal."""
    from repro_torch.md.state import init_state
    tmp = tmp_path_factory.mktemp("serve_logs")
    lat = simple_cubic()
    icfg = IntegratorConfig(dt=DT, spin_alpha=0.05, frozen_lattice=True,
                            temperature=10.0)

    def job(steps, seed, tenant, temp=None, **kw):
        st = init_state(lat, (3, 3, 3), temperature=10.0,
                        generator=torch.Generator().manual_seed(seed),
                        device="cpu")
        return SimJob(state=st, potential=HeisenbergDMIModel(d0=0.01),
                      cfg=icfg, masses=np.asarray(lat.masses),
                      magnetic=np.asarray(lat.moments) > 0, steps=steps,
                      temperature=temp, seed=seed, tenant=tenant, **kw)

    poison = protocol.Schedule(times=np.asarray([0.0, 1.0], np.float32),
                               values=np.full(2, np.nan, np.float32))
    cfg = ServeConfig(runlog=str(tmp / "serve.jsonl"),
                      workdir=str(tmp / "work"),
                      journal_dir=str(tmp / "journal"), slots=2, chunk=10,
                      requeue=RequeuePolicy(retries=2, backoff_s=0.0),
                      max_pending=5, shed_policy="priority",
                      tenant_priority={"gold": 1.0})

    def fleet():
        return [job(40, 1, "alice"), job(20, 2, "eve", temp=poison),
                job(30, 3, "bob", deadline_steps=10),
                job(40, 4, "carol"), job(20, 5, "dave")]

    srv = SimServer(cfg)
    hs = [srv.submit(j) for j in fleet()]
    srv._tick()
    assert hs[0].cancel()                   # running: at the next boundary
    srv.submit(job(20, 6, "gold"))          # sheds a queued job
    srv._tick()
    del srv                                  # "crash"
    srv = SimServer.recover(cfg)
    for j in fleet():
        srv.submit(j)
    srv.drain()
    return cfg.runlog, os.path.join(cfg.journal_dir, "journal.jsonl")


def _serving_lines(text):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("- serving:"))
    end = next(i for i, ln in enumerate(lines)
               if ln.startswith("- status:"))
    return lines[start:end]


def test_reports_match_the_reference(serving_logs):
    """The serving lines of ``runlog_report`` (the lifecycle events and the
    per-tenant table with its invariant) and the whole ``journal_report``
    read the same in both packages."""
    from repro.launch import report as jrep
    from repro_torch.launch import report as prep
    runlog, journal = serving_logs
    mine = _serving_lines(prep.runlog_report(runlog))
    theirs = _serving_lines(jrep.runlog_report(runlog))
    assert mine == theirs
    for token in ("job_requeued", "job_expired", "job_cancelled",
                  "job_shed", "recover:", "Per-tenant",
                  "closes exactly"):
        assert any(token in ln for ln in mine), (token, mine)
    assert prep.journal_report(journal) == jrep.journal_report(journal)
    assert prep._is_journal(journal) and jrep._is_journal(journal)
    assert not prep._is_journal(runlog)


def test_reference_potential_digest_reads_repr():
    """A reference limit: ``repro.serve.bucket.potential_digest`` digests
    ``repr`` of the parameters, which summarises an array past 1,000
    elements, so two production-spec weight sets that differ in one
    elided entry of ``w1`` share a bucket there; the port's digest of the
    parameter bytes tells them apart."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs.fege_spinlattice import config as jconfig
    from repro.core.potential import NEPSpinPotential as JPot
    from repro.core.potential import init_params as jinit
    from repro.serve.bucket import potential_digest as jdigest
    from repro_torch.serve.bucket import potential_digest
    spec = jconfig().spec
    p = jinit(spec, jax.random.PRNGKey(4))
    mid = tuple(s // 2 for s in p.w1.shape)
    p2 = p._replace(w1=p.w1.at[mid].add(1e-3))
    a = JPot(spec, p, moments=jnp.asarray([1.16, 0.0]))
    b = dataclasses.replace(a, params=p2)
    assert jdigest(a) == jdigest(b)          # the reference: one bucket
    tspec = NEPSpinSpec(**{f.name: getattr(spec, f.name)
                           for f in dataclasses.fields(spec)})
    mine = [NEPSpinPotential(tspec, params_from_jax(
        [np.asarray(x) for x in q], dtype=torch.float32, device="cpu"),
        torch.tensor([1.16, 0.0])) for q in (p, p2)]
    assert potential_digest(mine[0]) != potential_digest(mine[1])
