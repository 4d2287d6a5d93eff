"""The port's batched simulation job server (``repro_torch.serve``) on the
CPU: every case of ``tests/test_serve.py`` held as a property of the port,
the repairs the server rests on, and the launchers at smoke size.

* the supervisor writes a rollback's generator states into the caller's
  own ``torch.Generator`` objects, so a run that goes on with them after a
  supervised segment is bitwise the clean run (flat and ``Replicated``);
* ``Engine.ckpt_step_offset`` rebases checkpoint tags and ``run_tags``
  reach the ``run_start`` record;
* schedule padding and per-slot clocks, bucket keys (digests over bytes:
  two weight sets that ``repr`` would elide apart land in two buckets),
  admission and quotas;
* a packed batch with a backfill, bitwise the solo server's (both
  potentials), zero builds after a bucket's first chunk, the accounting
  invariant, eviction of a poisoned job with the supervisor's real
  ``evict_slot_hook``, the requeue ladder's strike-out, deadlines and
  timeouts, cancellation, load shedding, overload mode, and journal
  recovery bitwise;
* ``launch/serve.py``, ``launch/serve_smoke.py`` and
  ``launch/serve_chaos_smoke.py`` at smoke size with ``--device cpu``;
* no module of ``repro_torch.serve`` or the serving launchers imports
  ``jax`` or the JAX package.

The reference's own packed-vs-solo and requeue cases fail on this tree
(ROADMAP §3); here both pass.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.ensemble import protocol
from repro_torch.launch.report import journal_report, runlog_report
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.state import init_state
from repro_torch.parallel.plan import Replicated
from repro_torch.resilience import (Fault, FaultPlan, Supervisor,
                                    SupervisorConfig, install_faults)
from repro_torch.serve import (AdmissionError, RequeuePolicy, ServeConfig,
                               SimJob, SimServer, TenantQuota, bucket_key,
                               job_digest)
from repro_torch.telemetry import HealthConfig, Telemetry
from torch_one_thread import one_torch_thread  # noqa: F401

LAT = simple_cubic()


# ---------------------------------------------------------------------------
# repair: the supervisor keeps the caller's generators live
# ---------------------------------------------------------------------------

def _thermal_engine(plan=None):
    st = init_state(LAT, (4, 4, 4), temperature=300.0, spin_init="helix_x",
                    generator=torch.Generator().manual_seed(3), device="cpu")
    return Engine(potential=HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=st, masses=torch.tensor(LAT.masses,
                                                dtype=torch.float32),
                  magnetic=torch.tensor(LAT.moments) > 0, cutoff=5.0,
                  capacity=8, skin=0.2, temperature=300.0, plan=plan,
                  observables=("energy", "magnetization"), device="cpu")


def _gens(plan):
    if plan is None:
        return torch.Generator().manual_seed(5)
    return [torch.Generator().manual_seed(5 + r)
            for r in range(plan.replicas)]


@pytest.mark.parametrize("plan", [None, Replicated(2)],
                         ids=["flat", "replicated"])
def test_supervised_run_leaves_callers_generators_live(tmp_path, plan):
    """A supervised 40-step run with a NaN fault, then ``run(20)`` with the
    same generator objects, is bitwise the clean 60-step run: the rollback
    writes the checkpoint's generator states into the caller's objects."""
    clean = _thermal_engine(plan)
    clean.run(60, _gens(plan), chunk=10)

    eng = _thermal_engine(plan)
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=25, leaf="force"),)))
    gens = _gens(plan)
    sup = Supervisor(SupervisorConfig(max_retries=2))
    sup.run(eng, 40, gens, chunk=10, checkpoint_dir=str(tmp_path / "ck"),
            telemetry=Telemetry(health=HealthConfig()))
    assert [e["event"] for e in sup.events] == \
        ["rollback", "retry", "recovered"]
    eng.run(20, gens, chunk=10)
    for leaf in ("pos", "vel", "spin"):
        a, b = getattr(clean.state, leaf), getattr(eng.state, leaf)
        assert torch.equal(a, b), (leaf, float((a - b).abs().max()))


def test_rollback_restores_the_runs_own_checkpoint(tmp_path):
    """A checkpoint directory that holds higher step tags from an earlier
    run (a crashed serving incarnation's): the rollback restores the
    newest checkpoint this run wrote, and the run stays bitwise clean."""
    ck = str(tmp_path / "ck")
    stale = _thermal_engine()
    stale.ckpt_step_offset = 1000
    stale.run(20, torch.Generator().manual_seed(99), chunk=10,
              checkpoint_dir=ck)
    clean = _thermal_engine()
    clean.run(40, _gens(None), chunk=10)
    eng = _thermal_engine()
    install_faults(eng, FaultPlan(faults=(
        Fault(kind="nan", step=25, leaf="force"),)))
    sup = Supervisor(SupervisorConfig(max_retries=2))
    sup.run(eng, 40, _gens(None), chunk=10, checkpoint_dir=ck,
            telemetry=Telemetry(health=HealthConfig()))
    assert [e["event"] for e in sup.events] == \
        ["rollback", "retry", "recovered"]
    assert eng._step_now() == 40
    for leaf in ("pos", "vel", "spin"):
        assert torch.equal(getattr(clean.state, leaf),
                           getattr(eng.state, leaf)), leaf


def test_ckpt_step_offset_and_run_tags(tmp_path):
    """``ckpt_step_offset`` shifts the tag ``save`` writes (and the pin's
    unit); ``run_tags`` reach the runlog's ``run_start`` record."""
    from repro_torch.ckpt.checkpoint import available_steps
    from repro_torch.telemetry import read_runlog
    eng = _thermal_engine()
    eng.run_tags = {"bucket": "b0"}
    eng.ckpt_step_offset = 100
    log = str(tmp_path / "run.jsonl")
    eng.run(10, torch.Generator().manual_seed(1), chunk=10,
            checkpoint_dir=str(tmp_path / "ck"), telemetry=log)
    assert eng.ckpt_step() == 110
    assert available_steps(str(tmp_path / "ck")) == [110]
    start = read_runlog(log)[0]
    assert start["event"] == "run_start" and start["bucket"] == "b0"


# ---------------------------------------------------------------------------
# the reference suite's cases, as properties of the port
# ---------------------------------------------------------------------------

ICFG = IntegratorConfig(dt=2e-3, spin_alpha=0.05, frozen_lattice=True,
                        temperature=10.0)


def mkjob(steps, seed, tenant="t0", *, n_cells=(3, 3, 3), temp=None,
          field=None, obs_every=5, cfg=ICFG, d0=0.01):
    state = init_state(LAT, n_cells, temperature=10.0, spin_init="helix_x",
                       generator=torch.Generator().manual_seed(seed),
                       device="cpu")
    return SimJob(state=state, potential=HeisenbergDMIModel(d0=d0),
                  cfg=cfg, masses=np.asarray(LAT.masses),
                  magnetic=np.asarray(LAT.moments) > 0, steps=steps,
                  temperature=temp, field=field, obs_every=obs_every,
                  seed=seed, tenant=tenant)


def serve_cfg(tmp, name="serve", **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("chunk", 10)
    return ServeConfig(runlog=os.path.join(str(tmp), f"{name}.jsonl"),
                       workdir=os.path.join(str(tmp), name), **kw)


def _poison():
    return protocol.Schedule(times=np.asarray([0.0, 1.0], np.float32),
                             values=np.asarray([np.nan] * 2, np.float32))


def _same_stream(h, g, skip_rows=0):
    for name, rows in g.observables.items():
        assert np.array_equal(h.observables[name], rows[skip_rows:]), name


def _same_final(a, b):
    for leaf in ("pos", "spin", "vel"):
        assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf
    assert a.step == b.step


def test_pad_schedule_is_bitwise_neutral():
    s = protocol.piecewise([0.0, 0.1, 0.3], [300.0, 100.0, 50.0])
    p = protocol.pad_schedule(s, 8)
    assert p.times.shape == (8,) and p.values.shape == (8,)
    t = np.linspace(-0.1, 0.6, 29, dtype=np.float32)   # clamped beyond
    assert np.array_equal(s.at(t), p.at(t))
    with pytest.raises(ValueError):
        protocol.pad_schedule(s, 2)   # cannot shrink


def test_slot_schedules_per_slot_clocks():
    a = protocol.linear(0.0, 1.0, 0.0, 100.0)
    b = protocol.constant(7.0)
    stack = protocol.stack_schedules([a, b], k=4)
    assert stack.times.shape == (2, 4)
    assert stack.at(0.5) == pytest.approx([50.0, 7.0])      # one clock
    assert stack.at(np.asarray([0.25, 99.0])) == pytest.approx([25.0, 7.0])


def test_bucket_key_bins_jobs(tmp_path):
    cfg = serve_cfg(tmp_path)
    j1 = mkjob(20, 1)
    j2 = mkjob(40, 2, temp=protocol.linear(0.0, 0.1, 300.0, 50.0))
    assert bucket_key(j1, cfg) == bucket_key(j2, cfg)  # protocols differ ok
    assert bucket_key(mkjob(20, 3, n_cells=(4, 3, 3)), cfg) \
        != bucket_key(j1, cfg)                          # geometry differs
    assert bucket_key(mkjob(20, 3, d0=0.02), cfg) != bucket_key(j1, cfg)
    assert bucket_key(mkjob(20, 3, obs_every=10), cfg) != bucket_key(j1, cfg)
    assert isinstance(bucket_key(j1, cfg).id, str)


def _nep(seed=4, dtype=torch.float64):
    from repro_torch.configs.fege_spinlattice import smoke_config
    from repro_torch.launch.serve import nep_potential
    return nep_potential(smoke_config().spec, seed, device="cpu",
                         dtype=dtype)


def test_potential_digest_reads_parameter_bytes():
    """Two NEP-SPIN weight sets that differ in one entry ``repr`` elides
    (an array past 1,000 elements prints summarised) get two digests; the
    same weights get one, whatever tensor objects hold them."""
    import dataclasses
    from repro_torch.configs.fege_spinlattice import config
    from repro_torch.launch.serve import nep_potential
    from repro_torch.serve.bucket import potential_digest
    pot = nep_potential(config().spec, 4, device="cpu")  # production spec
    w1 = pot.params.w1
    assert w1.numel() > 1000
    w1b = w1.clone()
    w1b[tuple(s // 2 for s in w1.shape)] += 1e-3
    other = dataclasses.replace(pot, params=pot.params._replace(w1=w1b))
    assert repr(w1b) == repr(w1)          # what a repr digest would read
    assert potential_digest(other) != potential_digest(pot)
    copy = dataclasses.replace(pot, params=type(pot.params)(
        *(p.clone() for p in pot.params)))
    assert potential_digest(copy) == potential_digest(pot)


def test_job_digest_is_the_same_in_another_process(tmp_path):
    """A job's digest (the journal's idempotency key) is computed over host
    bytes, so a fresh process computes the same one."""
    import subprocess
    import sys
    code = ("import torch, sys; sys.path.insert(0, 'tests');"
            "import test_torch_serve as t;"
            "from repro_torch.serve import job_digest;"
            "print(job_digest(t.mkjob(40, 9, temp=t.protocol.linear("
            "0.0, 0.1, 300.0, 50.0), field=[0.0, 0.0, 1.0])))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, env={**os.environ,
                         "PYTHONPATH": os.path.join(root, "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    here = job_digest(mkjob(40, 9, temp=protocol.linear(0.0, 0.1, 300.0,
                                                        50.0),
                            field=[0.0, 0.0, 1.0]))
    assert out.stdout.strip() == here


def test_admission_rejects_malformed(tmp_path):
    srv = SimServer(serve_cfg(tmp_path))
    with pytest.raises(AdmissionError):
        srv.submit(mkjob(23, 1))                  # steps % obs_every
    with pytest.raises(AdmissionError):
        srv.submit(mkjob(21, 1, obs_every=3))     # obs_every !| chunk
    bad = mkjob(20, 1)
    spin = bad.state.spin.clone()
    spin[0, 0] = float("nan")
    bad.state = bad.state._replace(spin=spin)
    with pytest.raises(AdmissionError, match="state.spin"):
        srv.submit(bad)                           # non-finite state
    many = protocol.piecewise(list(np.linspace(0, 1, 12)),
                              list(np.linspace(300, 50, 12)))
    with pytest.raises(AdmissionError):
        srv.submit(mkjob(20, 1, temp=many))       # too many knots
    moving = IntegratorConfig(dt=2e-3, spin_alpha=0.05, lattice_gamma=1.0,
                              temperature=10.0)
    with pytest.raises(AdmissionError):
        srv.submit(mkjob(20, 1, cfg=moving))      # lattice not frozen


def test_admission_quota(tmp_path):
    cfg = serve_cfg(tmp_path, quotas={
        "busy": TenantQuota(max_jobs=2, max_steps=50)})
    srv = SimServer(cfg)
    srv.submit(mkjob(20, 1, "busy"))
    with pytest.raises(AdmissionError):
        srv.submit(mkjob(40, 2, "busy"))          # 20 + 40 > 50 steps
    srv.submit(mkjob(20, 2, "busy"))
    with pytest.raises(AdmissionError):
        srv.submit(mkjob(10, 3, "busy"))          # third job
    srv.submit(mkjob(10, 3, "other"))             # other tenants fine


@pytest.fixture(scope="module")
def packed_run(tmp_path_factory):
    """One packed 2-slot server over 3 mixed-size jobs (the third
    backfills a freed slot) + the same jobs through a 1-slot server."""
    tmp = tmp_path_factory.mktemp("serve")
    specs = [  # (steps, seed, tenant, temperature)
        (20, 11, "alice", None),
        (30, 12, "bob", protocol.linear(0.0, 0.06, 10.0, 80.0)),
        (10, 13, "alice", 25.0),
    ]
    packed = SimServer(serve_cfg(tmp, "packed"))
    handles = [packed.submit(mkjob(s, k, t, temp=tp))
               for s, k, t, tp in specs]
    packed.drain()
    solo = SimServer(serve_cfg(tmp, "solo", slots=1))
    solos = [solo.submit(mkjob(s, k, t, temp=tp))
             for s, k, t, tp in specs]
    solo.drain()
    return packed, handles, solos


def test_packed_jobs_complete(packed_run):
    packed, handles, solos = packed_run
    for h in handles + solos:
        assert h.status == "done", h.error
        assert h.rows_streamed == h.job.steps // h.job.obs_every
        assert h.final_state is not None      # chunk-aligned budgets
        t = h.times
        np.testing.assert_allclose(
            t, (np.arange(len(t)) + 1) * h.job.obs_every * h.job.cfg.dt)


def test_packed_batch_parity_vs_solo(packed_run):
    """Every packed job's stream and final state are BITWISE the solo
    run's - including job 3, which backfilled a freed slot mid-batch."""
    packed, handles, solos = packed_run
    (rt,) = packed.buckets.values()
    assert rt.backfills == 1
    for h, g in zip(handles, solos):
        _same_stream(h, g)
        _same_final(h.final_state, g.final_state)


def test_zero_steady_state_recompiles(packed_run):
    """No kernel build or load after a bucket's first chunk; the
    reference's ``warmup_compiles >= 1`` is an XLA fact (the port builds
    and loads a library once per process, and plain versions run here)."""
    packed, handles, _ = packed_run
    acct = packed.accounting
    assert len({h.bucket for h in handles}) == 1
    (bucket,) = acct.buckets.values()
    assert bucket["chunks"] == 3            # 20+30+10 steps pack into 3
    assert bucket["steady_compiles"] == 0
    assert bucket["replicas"] == 2


def test_accounting_consistency_and_tenant_sums(packed_run):
    packed, handles, _ = packed_run
    acct = packed.accounting
    assert acct.consistent()
    assert acct.tenants["alice"]["charged_steps"] == 30
    assert acct.tenants["bob"]["charged_steps"] == 30
    assert acct.tenants["alice"]["jobs_done"] == 2
    assert acct.tenants["bob"]["jobs_done"] == 1
    assert acct.charged_steps + acct.idle_steps == acct.computed_slot_steps
    assert "Run report" in runlog_report(packed.cfg.runlog)


def test_nepspin_packed_parity_vs_solo(tmp_path):
    """NEP-SPIN jobs through the kernel path (its plain versions here), 2
    slots with a backfill, bitwise the solo server's: what the card runs
    with one K1 and one K2 launch per step for all slots."""
    from repro_torch.launch.serve import build_nep_fleet
    pot = _nep(dtype=torch.float32)

    def fleet():
        return build_nep_fleet(pot, [(2, 2, 2)], 3, 5, budgets=(20, 30))

    runs = {}
    for name, slots in (("packed", 2), ("solo", 1)):
        srv = SimServer(serve_cfg(tmp_path, name, slots=slots))
        runs[name] = (srv, [srv.submit(j) for j in fleet()])
        srv.drain()
    (srv, hs), (_, gs) = runs["packed"], runs["solo"]
    assert srv.buckets[hs[0].bucket].backfills == 1
    for h, g in zip(hs, gs):
        assert h.status == g.status == "done", (h.error, g.error)
        _same_stream(h, g)
        _same_final(h.final_state, g.final_state)
    assert srv.accounting.consistent()


def test_poisoned_job_evicted_mates_survive(tmp_path):
    """A NaN temperature schedule: the supervisor's evict rung calls the
    packer's real ``evict_slot_hook``, which blames the slot and retires
    the job; the rollback restores the batch-mate's carry and generator,
    so it completes bitwise its solo run."""
    srv = SimServer(serve_cfg(tmp_path, "evict"))
    good = srv.submit(mkjob(20, 21, "alice"))
    bad = srv.submit(mkjob(20, 22, "eve", temp=_poison()))
    srv.drain()
    assert bad.status == "evicted"
    assert "non-finite" in (bad.error or "")
    assert good.status == "done"

    solo = SimServer(serve_cfg(tmp_path, "evict-solo", slots=1))
    ref = solo.submit(mkjob(20, 21, "alice"))
    solo.drain()
    _same_stream(good, ref)
    _same_final(good.final_state, ref.final_state)

    acct = srv.accounting
    assert acct.consistent()
    assert acct.tenants["eve"]["jobs_evicted"] == 1
    assert acct.tenants["eve"]["charged_steps"] > 0   # occupied segments
    assert len(acct.evictions) == 1
    assert acct.evictions[0]["job"] == bad.id
    assert "evict" in runlog_report(srv.cfg.runlog)


def test_eviction_requeue_strikes_out_accounting_closes(tmp_path):
    """A poisoned job with retry budget is evicted, quarantined, requeued
    once, evicted again (second same-class strike -> permanent EVICTED);
    the accounting invariant closes across the whole ladder and the
    healthy batch-mate is bitwise unperturbed."""
    cfg = serve_cfg(tmp_path, "requeue",
                    requeue=RequeuePolicy(retries=3, backoff_s=0.0,
                                          max_strikes=2))
    srv = SimServer(cfg)
    good = srv.submit(mkjob(30, 31, "alice"))
    bad = srv.submit(mkjob(20, 32, "eve", temp=_poison()))
    srv.drain()
    assert bad.status == "evicted"      # struck out, not retry-exhausted
    assert bad.attempts == 2            # seated, evicted, requeued, evicted
    assert good.status == "done", good.error

    acct = srv.accounting
    assert acct.consistent()
    assert len(acct.evictions) == 2
    assert len(acct.requeues) == 1
    assert acct.tenants["eve"]["jobs_evicted"] == 2
    assert acct.tenants["eve"]["jobs_requeued"] == 1
    assert acct.tenants["eve"]["charged_steps"] == 20

    solo = SimServer(serve_cfg(tmp_path, "requeue-solo", slots=1))
    ref = solo.submit(mkjob(30, 31, "alice"))
    solo.drain()
    _same_stream(good, ref)
    _same_final(good.final_state, ref.final_state)


def test_deadline_and_timeout_expiry(tmp_path):
    srv = SimServer(serve_cfg(tmp_path, "expire", slots=1))
    late = mkjob(40, 51, "alice")
    late.deadline_steps = 10            # one chunk of budget, 4 needed
    h1 = srv.submit(late)
    slow = mkjob(20, 52, "bob")
    slow.timeout_s = 1e-6               # expires while queued behind h1
    h2 = srv.submit(slow)
    srv.drain()
    assert h1.status == "failed" and "deadline" in h1.error
    assert h1.done_steps == 10          # got exactly its budgeted chunk
    assert h2.status == "failed" and "timeout" in h2.error
    assert h2.done_steps == 0           # never seated
    acct = srv.accounting
    assert acct.consistent()
    assert acct.tenants["alice"]["jobs_expired"] == 1
    assert acct.tenants["bob"]["jobs_expired"] == 1
    assert acct.tenants["alice"]["charged_steps"] == 10


def test_cancel_queued_and_running(tmp_path):
    srv = SimServer(serve_cfg(tmp_path, "cancel", slots=1))
    run = srv.submit(mkjob(40, 61, "alice"))
    parked = srv.submit(mkjob(20, 62, "bob"))
    assert parked.cancel() is True
    assert parked.status == "cancelled"     # queued: immediate
    srv._tick()                             # one segment for `run`
    assert run.status == "running"
    assert run.cancel() is True             # honored at next boundary
    srv.drain()
    assert run.status == "cancelled"
    assert run.done_steps == 20             # the in-flight chunk completes
    assert run.rows_streamed == 4           # its rows still stream
    assert run.cancel() is False            # already terminal
    acct = srv.accounting
    assert acct.consistent()
    assert acct.tenants["alice"]["jobs_cancelled"] == 1
    assert acct.tenants["alice"]["charged_steps"] == 20


def test_load_shedding_reject_and_priority(tmp_path):
    srv = SimServer(serve_cfg(tmp_path, "shed-reject", max_pending=1))
    srv.submit(mkjob(20, 71, "alice"))
    with pytest.raises(AdmissionError):     # reject-newest (default)
        srv.submit(mkjob(20, 72, "bob"))

    srv2 = SimServer(serve_cfg(tmp_path, "shed-prio", max_pending=1,
                               shed_policy="priority",
                               tenant_priority={"gold": 1.0, "free": 0.0}))
    low = srv2.submit(mkjob(20, 73, "free"))
    gold = srv2.submit(mkjob(20, 74, "gold"))   # sheds `low` to get in
    assert low.status == "shed"
    with pytest.raises(AdmissionError):
        # a newcomer may only shed a STRICTLY lower-priority victim
        srv2.submit(mkjob(20, 75, "free"))
    srv2.drain()
    assert gold.status == "done"
    acct = srv2.accounting
    assert acct.consistent()
    assert acct.tenants["free"]["jobs_shed"] == 1
    assert len(acct.sheds) == 1


def test_overload_mode_stretches_obs_every(tmp_path):
    srv = SimServer(serve_cfg(tmp_path, "overload", overload_after=1,
                              overload_obs_factor=2))
    h1 = srv.submit(mkjob(20, 81))
    h2 = srv.submit(mkjob(20, 82))      # admitted in overload mode
    assert h1.job.obs_every == 5
    assert h2.job.obs_every == 10       # degraded cadence, not refusal
    srv.drain()
    assert h1.status == "done" and h1.rows_streamed == 4
    assert h2.status == "done" and h2.rows_streamed == 2


def test_journal_recovery_resumes_bitwise(tmp_path):
    """Kill-and-recover (in-process): after two committed segments the
    server is abandoned mid-flight; ``SimServer.recover`` + resubmission
    deduplicates the completed job, re-seats the interrupted one from its
    watermark (carry and generators from the journaled checkpoint), and
    the remaining stream + final state are bitwise the uninterrupted
    run's.  Accounting closes across both incarnations."""
    def fleet():
        return [mkjob(30, 91, "alice"),
                mkjob(20, 92, "bob",
                      temp=protocol.linear(0.0, 0.06, 10.0, 80.0))]

    ref_srv = SimServer(serve_cfg(tmp_path, "ref"))
    refs = [ref_srv.submit(j) for j in fleet()]
    ref_srv.drain()

    cfg = serve_cfg(tmp_path, "wal",
                    journal_dir=os.path.join(str(tmp_path), "wal-journal"))
    srv1 = SimServer(cfg)
    h1 = [srv1.submit(j) for j in fleet()]
    srv1._tick()
    srv1._tick()                        # bob done (20), alice at 20/30
    assert h1[1].status == "done"
    assert h1[0].status == "running"
    del srv1                            # "crash": never drained

    srv2 = SimServer.recover(cfg)
    h2 = [srv2.submit(j) for j in fleet()]
    assert h2[1].recovered and h2[1].status == "done"   # deduplicated
    assert h2[1].rows_streamed == 0     # rows went to incarnation 1
    assert h2[0].recovered and h2[0].status == "queued"
    assert h2[0].done_steps == 20 and h2[0].rows_base == 4
    srv2.drain()
    assert h2[0].status == "done", h2[0].error
    _same_stream(h2[0], refs[0], skip_rows=4)
    _same_final(h2[0].final_state, refs[0].final_state)

    acct = srv2.accounting
    assert acct.consistent()
    assert acct.recoveries == 1
    for b in acct.buckets.values():
        assert b["steady_compiles"] == 0
    assert acct.tenants["alice"]["charged_steps"] == 30
    assert acct.tenants["bob"]["charged_steps"] == 20
    assert "Per-tenant" in runlog_report(cfg.runlog)
    jrep = journal_report(os.path.join(cfg.journal_dir, "journal.jsonl"))
    assert "commit" in jrep and "recovered" in jrep


def test_background_worker_serves_submitted_jobs(tmp_path):
    """``start()`` drives the batch from a worker thread; the streams are
    bitwise the synchronous ``drain()``'s."""
    jobs = lambda: [mkjob(20, 101, "alice"), mkjob(30, 102, "bob")]  # noqa
    sync = SimServer(serve_cfg(tmp_path, "sync"))
    refs = [sync.submit(j) for j in jobs()]
    sync.drain()
    srv = SimServer(serve_cfg(tmp_path, "threaded"))
    srv.start()
    hs = [srv.submit(j) for j in jobs()]
    for h in hs:
        assert h.wait(timeout=120) == "done", h.error
    srv.stop()
    for h, g in zip(hs, refs):
        _same_stream(h, g)
        _same_final(h.final_state, g.final_state)


# ---------------------------------------------------------------------------
# the launchers at smoke size, and the package's imports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--smoke"], ["--smoke", "--threaded", "--report"],
    ["--smoke", "--potential", "nepspin"]],
    ids=["drain", "threaded", "nepspin"])
def test_serve_cli(tmp_path, argv, capsys):
    from repro_torch.launch import serve
    rc = serve.main(argv + ["--device", "cpu",
                            "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "accounting consistent: True" in out
    assert "2 shape bucket(s)" in out


def test_serve_smoke_launcher():
    from repro_torch.launch import serve_smoke
    out = serve_smoke.main(["--device", "cpu"])
    assert out["jobs"] == 6 and out["buckets"] == 2 and out["consistent"]


def test_serve_chaos_smoke_launcher():
    from repro_torch.launch import serve_chaos_smoke
    out = serve_chaos_smoke.main(["--device", "cpu"])
    assert out["child_rc"] == -9
    assert out["deduplicated"] >= 1 and out["resumed"] >= 1


def test_serving_modules_import_no_jax():
    """``repro_torch.serve`` and the serving launchers import neither
    ``jax`` nor the JAX package ``repro``."""
    import ast
    import pathlib
    src = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    files = sorted((src / "serve").glob("*.py")) + [
        src / "launch" / f for f in ("serve.py", "serve_smoke.py",
                                     "serve_chaos_smoke.py", "report.py")]
    assert len(files) == 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f.name, n)
