"""The Sharded plan's faults, the capacity rung and elastic restore on gloo
ranks, against the JAX package's.

One f64 JAX subprocess with 2 forced host devices runs
``tests/test_resilience.py``'s sharded scenarios: simple cubic 6x6x6 at
300 K, helix spins, Heisenberg-DMI, 40 NVE steps in chunks of 10 on
``Sharded()`` - a clean run; a persistent migration overflow on device 1
under the supervisor (``degrade_after=2``); a checkpoint after 20 steps
restored onto the same mesh through the gather + re-bin + rebuild path and
elastically onto one device, both continued 20 steps, and the one-device
run's checkpoint restored onto two devices and onto one.  It saves the
initial state, its events, capacities and energies.

The port runs the same scenarios from that state on 2 gloo ranks: NaN and
halo-face recovery under the supervisor (events ``rollback, retry,
recovered``, bitwise the clean run), the overflow ladder (the reference's
events, ``cap1 >= 2 cap0`` and its capacities, step 40), elastic restore 2
-> 1 -> 2 (``down_delta`` < 1e-10, ``down_end_delta`` < 1e-8, ``up_delta``
< 1e-10, the reference's energies within 1e-9, an ``elastic_restore``
event) and the gathered state bitwise the writer's.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import simple_cubic
from repro_torch.md.state import state_from_numpy
from repro_torch.parallel.plan import Sharded
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=2 "
                           + os.environ.get("XLA_FLAGS", ""))
import jax
jax.config.update("jax_enable_x64", True)
import json, tempfile
import numpy as np
import jax.numpy as jnp
from repro.core.hamiltonian import HeisenbergDMIModel
from repro.md.engine import Engine
from repro.md.integrator import IntegratorConfig
from repro.md.lattice import simple_cubic
from repro.md.state import init_state
from repro.parallel.plan import Sharded
from repro.resilience import (Fault, FaultPlan, Supervisor, SupervisorConfig,
                              install_faults)

lat = simple_cubic()
st = init_state(lat, (6, 6, 6), temperature=300.0, spin_init="helix_x",
                key=jax.random.PRNGKey(3))


def make_engine(plan):
    return Engine(potential=HeisenbergDMIModel(d0=0.008),
                  cfg=IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                       lattice_gamma=1.0),
                  state=st, masses=jnp.asarray(lat.masses),
                  magnetic=jnp.asarray(lat.moments) > 0, cutoff=5.0,
                  capacity=16, skin=0.2, plan=plan,
                  observables=("energy", "magnetization"))


tmp = tempfile.mkdtemp()
key = jax.random.PRNGKey(0)
out = {k: np.asarray(getattr(st, k))
       for k in ("pos", "vel", "spin", "types", "box")}
ref = make_engine(Sharded())
ref.run(40, key, chunk=10)
out.update({f"clean_{k}": np.asarray(getattr(ref.state, k))
            for k in ("pos", "vel", "spin")})
res = {}
eng2 = make_engine(Sharded())
cap0 = int(eng2._rplan.dspec.capacity)
install_faults(eng2, FaultPlan(faults=(
    Fault(kind="overflow", step=15, device=1, once=False),)))
sup2 = Supervisor(SupervisorConfig(max_retries=4, degrade_after=2))
sup2.run(eng2, 40, key, chunk=10, checkpoint_dir=os.path.join(tmp, "ck2"))
res["overflow"] = {"events": [e["event"] for e in sup2.events],
                   "cap0": cap0, "cap1": int(eng2._rplan.dspec.capacity),
                   "final_step": int(eng2._step_now())}
eng4 = make_engine(Sharded())
ck = os.path.join(tmp, "ck4")
eng4.run(20, key, chunk=10, checkpoint_dir=ck)
res["e_live"] = float(np.asarray(eng4.energy))
eng4b = make_engine(Sharded())
key4b = eng4b.restore(ck, plan=Sharded())
res["e_same"] = float(np.asarray(eng4b.energy))
eng5 = make_engine(Sharded())
key5 = eng5.restore(ck, plan=Sharded(devices=tuple(jax.devices()[:1])))
res["e_down"] = float(np.asarray(eng5.energy))
eng4b.run(20, key4b, chunk=10)
eng5.run(20, key5, chunk=10)
res["e_same_end"] = float(np.asarray(eng4b.energy))
res["e_down_end"] = float(np.asarray(eng5.energy))
ck5 = os.path.join(tmp, "ck5")
eng5.save(ck5, key=jax.random.PRNGKey(7))
eng6 = make_engine(Sharded(devices=tuple(jax.devices()[:1])))
eng6.restore(ck5, plan=Sharded())
eng7 = make_engine(Sharded(devices=tuple(jax.devices()[:1])))
eng7.restore(ck5, plan=Sharded(devices=tuple(jax.devices()[:1])))
res["e_up"] = float(np.asarray(eng6.energy))
res["e_up_one"] = float(np.asarray(eng7.energy))
np.savez(sys.argv[1], **out)
with open(sys.argv[2], "w") as f:
    json.dump(res, f)
"""


def _make_engine(st, plan):
    lat = simple_cubic()
    return Engine(HeisenbergDMIModel(d0=0.008),
                  IntegratorConfig(dt=2e-3, spin_alpha=0.05,
                                   lattice_gamma=1.0),
                  st, torch.tensor(lat.masses, dtype=F64),
                  torch.tensor(lat.moments) > 0, 5.0, plan=plan,
                  capacity=16, skin=0.2,
                  observables=("energy", "magnetization"), device="cpu")


def _state(d):
    ref = np.load(os.path.join(d, "ref.npz"))
    return state_from_numpy(*(ref[k] for k in ("pos", "vel", "spin", "types",
                                               "box")), dtype=F64,
                            device="cpu")


def _bitwise(a, b, names=("pos", "vel", "spin")) -> bool:
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in names)


def _two_ranks(rank, d):
    import torch.distributed as dist

    from repro_torch.ckpt.elastic import gather_md_state
    from repro_torch.resilience import (Fault, FaultPlan, Supervisor,
                                        SupervisorConfig, install_faults)
    from repro_torch.telemetry import HealthConfig, Telemetry
    torch.set_num_threads(1)
    st = _state(d)
    out = {}
    clean = _make_engine(st, Sharded())
    clean.run(40, chunk=10)
    out["clean"] = {k: getattr(clean.state, k).numpy().tolist()
                    for k in ("pos", "vel", "spin")}
    for kind, fault in (("nan", Fault(kind="nan", step=25, leaf="spin")),
                        ("halo", Fault(kind="halo", step=15, device=1))):
        eng = _make_engine(st, Sharded())
        inj = install_faults(eng, FaultPlan(faults=(fault,)))
        sup = Supervisor(SupervisorConfig(max_retries=2))
        got = sup.run(eng, 40, None, chunk=10,
                      checkpoint_dir=os.path.join(d, f"ck_{kind}"),
                      telemetry=Telemetry(health=HealthConfig()))
        out[kind] = {"events": [e["event"] for e in sup.events],
                     "bitwise": _bitwise(got, clean.state),
                     "fired": len(inj.fired), "step": eng._step_now()}
    eng2 = _make_engine(st, Sharded())
    cap0 = eng2._rplan.dspec.capacity
    install_faults(eng2, FaultPlan(faults=(
        Fault(kind="overflow", step=15, device=1, once=False),)))
    sup2 = Supervisor(SupervisorConfig(max_retries=4, degrade_after=2))
    sup2.run(eng2, 40, None, chunk=10,
             checkpoint_dir=os.path.join(d, "ck_overflow"))
    degrade = next(e for e in sup2.events if e["event"] == "degrade")
    out["overflow"] = {"events": [e["event"] for e in sup2.events],
                       "cap0": cap0, "cap1": eng2._rplan.dspec.capacity,
                       "final_step": eng2._step_now(),
                       "action": degrade["action"]}
    # elastic 2 -> 1 -> 2
    ck = os.path.join(d, "ck4")
    eng4 = _make_engine(st, Sharded())
    eng4.run(20, chunk=10, checkpoint_dir=ck)
    e_live = eng4.energy
    gathered, seed, step = gather_md_state(
        ck, eng4._domain_ckpt_tree(eng4._carry))
    out["gathered_bitwise"] = (_bitwise(gathered, eng4.state,
                                        ("pos", "vel", "spin", "types"))
                               and step == 20 and seed is None)
    same = _make_engine(st, Sharded())
    same.restore(ck, plan=Sharded())
    e_same = same.energy
    down = _make_engine(st, Sharded())
    sup5 = Supervisor()
    try:
        sup5.elastic_restore(down, ck, Sharded(devices=(0,)))
        out["outside"] = None
    except ValueError as err:           # rank 1 holds no part of (0,)
        out["outside"] = str(err)
    same.run(20, chunk=10)
    ck5 = os.path.join(d, "ck5")
    if rank == 0:
        e_down = down.energy
        down.run(20, chunk=10)
        out["elastic"] = {"e_live": e_live, "e_same": e_same,
                          "e_down": e_down, "e_same_end": same.energy,
                          "e_down_end": down.energy,
                          "mesh_down": down._rplan.world,
                          "events": [e["event"] for e in sup5.events],
                          "layouts": [sup5.events[0]["from_layout"],
                                      sup5.events[0]["to_layout"]]}
        down.save(ck5, torch.Generator().manual_seed(7))
        one = _make_engine(st, Sharded(devices=(0,)))
        one.restore(ck5, plan=Sharded(devices=(0,)))
        out["elastic"]["e_up_one"] = one.energy
    dist.barrier()
    up = _make_engine(st, Sharded())
    gen = up.restore(ck5, plan=Sharded())
    out["up"] = {"mesh_up": up._rplan.world, "e_up": up.energy,
                 "generator": isinstance(gen, torch.Generator)}
    with open(os.path.join(d, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.parallel.ranks import spawn
    d = str(tmp_path_factory.mktemp("elastic"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, os.path.join(d, "ref.npz"),
         os.path.join(d, "ref.json")],
        env=env, capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    spawn(_two_ranks, 2, d, workdir=d)
    with open(os.path.join(d, "ref.json")) as f:
        ref = json.load(f)
    ranks = []
    for r in range(2):
        with open(os.path.join(d, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    return dict(ref=ref, ref_np=dict(np.load(os.path.join(d, "ref.npz"))),
                ranks=ranks)


def test_clean_run_matches_reference(runs):
    """The port's clean 40-step Sharded run on 2 ranks within 1e-9 of the
    reference's (the trajectory the recoveries must reproduce)."""
    clean, ref = runs["ranks"][0]["clean"], runs["ref_np"]
    for k in ("pos", "vel", "spin"):
        assert np.abs(np.asarray(clean[k]) - ref[f"clean_{k}"]).max() < 1e-9


@pytest.mark.parametrize("kind", ["nan", "halo"])
def test_sharded_fault_recovery_is_bitwise(runs, kind):
    """A NaN in a spin, and NaN in rank 1's last local x-cell layer of
    positions (a corrupted halo face): rolled back and retried on both
    ranks, bitwise the clean run."""
    for res in runs["ranks"]:
        r = res[kind]
        assert r["events"] == ["rollback", "retry", "recovered"], r
        assert r["bitwise"] and r["step"] == 40
    # the halo fault fires on rank 1 only; the NaN on every rank's slab
    assert [res["halo"]["fired"] for res in runs["ranks"]] == [1, 1]


def test_overflow_capacity_ladder(runs):
    """A persistent migration overflow on rank 1 climbs the capacity rung:
    the reference's events, ``cap1 >= 2 cap0`` (its capacities), step
    40."""
    ref = runs["ref"]["overflow"]
    for res in runs["ranks"]:
        r = res["overflow"]
        assert r["events"] == ref["events"] and "degrade" in r["events"]
        assert r["action"] == "capacity"
        assert r["cap1"] >= 2 * r["cap0"]
        assert (r["cap0"], r["cap1"]) == (ref["cap0"], ref["cap1"])
        assert r["final_step"] == 40


def test_elastic_restore_two_one_two(runs):
    """2 ranks -> 1 -> 2: the one-rank restore matches a same-mesh restore
    through the same gather + re-bin + rebuild (1e-10), 20 steps on
    (1e-8); scaling back up matches a one-rank restore (1e-10); the
    energies are the reference's; rank 1, outside ``devices=(0,)``, is
    refused by name."""
    r0, r1 = runs["ranks"]
    el, ref = r0["elastic"], runs["ref"]
    assert el["mesh_down"] == 1 and r0["up"]["mesh_up"] == 2
    assert abs(el["e_same"] - el["e_live"]) < 1e-4
    assert abs(el["e_down"] - el["e_same"]) < 1e-10
    assert abs(el["e_down_end"] - el["e_same_end"]) < 1e-8
    assert abs(r0["up"]["e_up"] - el["e_up_one"]) < 1e-10
    assert r1["up"]["e_up"] == r0["up"]["e_up"] and r0["up"]["generator"]
    assert el["events"] == ["elastic_restore"]
    assert (el["layouts"][0]["devices"], el["layouts"][1]["devices"]) == \
        (2, 1)
    for name in ("e_live", "e_same", "e_down", "e_same_end", "e_down_end"):
        assert abs(el[name] - ref[name]) < 1e-9, name
    assert abs(r0["up"]["e_up"] - ref["e_up"]) < 1e-9
    assert r0["outside"] is None and "rank 1" in r1["outside"]


def test_gathered_state_is_the_writers(runs):
    """``gather_md_state`` reads every rank's shard and un-bins them into
    the flat state, in input atom order: bitwise the state the 2-rank
    writer held."""
    assert all(r["gathered_bitwise"] for r in runs["ranks"])


def test_elastic_helpers(tmp_path):
    """The policy half of ``ckpt/elastic.py``: the straggler policy and
    ``straggler_chunks`` (the report's), ``run_resumable`` resuming after
    its newest checkpoint, ``redecompose`` re-binning a DomainState onto
    another grid, and ``rank_generator`` one stream per (seed, rank)."""
    from repro_torch.ckpt.elastic import (StragglerPolicy, rank_generator,
                                          redecompose, run_resumable,
                                          straggler_chunks)
    from repro_torch.launch import report
    from repro_torch.parallel.domain import (DomainSpec, pack_domain,
                                             unpack_domain)
    pol = StragglerPolicy(min_samples=3)
    assert [pol.record(t) for t in (1.0, 1.0, 1.0, 2.0)] == \
        [False, False, False, True]
    walls = [9.0, 1.0, 1.0, 1.0, 1.0, 3.0]
    assert straggler_chunks(walls) == report.straggler_chunks(walls) == [5]
    ck = str(tmp_path / "loop")
    state, start = run_resumable(lambda s: {"x": s["x"] + 1.0},
                                 {"x": np.zeros(2)}, 4, ck, every=2,
                                 async_save=False)
    assert start == 0 and state["x"][0] == 4.0
    state, start = run_resumable(lambda s: {"x": s["x"] + 1.0},
                                 {"x": np.zeros(2)}, 6, ck, every=2,
                                 async_save=False)
    assert start == 4 and state["x"][0] == 6.0
    rng = np.random.default_rng(2)
    pos = rng.random((30, 3)) * 18.0
    kw = dict(cutoff=5.0, box=(18.0, 18.0, 18.0), capacity=12)
    old = DomainSpec(cells=(3, 3, 3), **kw)
    new = DomainSpec(cells=(3, 3, 1), axis_map=(None, None, None),
                     cutoff=5.0, box=(18.0, 18.0, 18.0), capacity=20)
    dst = pack_domain(old, pos, pos * 0, pos * 0, np.zeros(30, np.int32))
    again = redecompose(old, new, dst)
    assert again.pos.shape == (3, 3, 1, 20, 3)
    assert sorted(map(tuple, unpack_domain(again)[0])) == \
        sorted(map(tuple, pos))
    a, b = rank_generator(5, 0, "cpu"), rank_generator(5, 1, "cpu")
    assert not torch.equal(torch.randn(4, generator=a),
                           torch.randn(4, generator=b))
    assert torch.equal(torch.randn(4, generator=rank_generator(5, 1, "cpu")),
                       torch.randn(4, generator=rank_generator(5, 1, "cpu")))
