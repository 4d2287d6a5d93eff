"""The port's checkpoint-restart: the checkpoint module (ports of
``tests/test_ckpt.py``'s roundtrip, GC with a pin, invisible partial
checkpoint, stale-tmp sweep, incompatible tree, and async failures on
``join`` and on the next save; an async save holds the values of its
call) and the flat Engine's bitwise resume.

Resume: an uninterrupted thermostatted run (Langevin lattice, stochastic
LLG spins, so the generator's state matters; a small skin, so it crosses
rebuilds) against the same run interrupted at a chunk boundary and resumed
in a FRESH Engine from the checkpoint - ``torch.equal`` on pos, vel, spin,
the step, the rebuild count and the resumed chunks' trace rows, for the
Heisenberg-DMI model and for NEP-SPIN (autograd and the kernel path's
plain version).  ``resume=True`` picks up the newest checkpoint.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import (available_steps, latest_step,
                                         load_checkpoint, save_checkpoint,
                                         sweep_tmp)
from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.hamiltonian import HeisenbergDMIModel
from repro_torch.core.potential import NEPSpinPotential, init_params
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import IntegratorConfig
from repro_torch.md.lattice import b20_fege, simple_cubic
from repro_torch.md.state import init_state
from torch_one_thread import one_torch_thread  # noqa: F401


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "b": {"c": torch.randn((4,), generator=g, dtype=torch.float64),
                  "d": torch.tensor(3, dtype=torch.int32), "n": 7,
                  "x": 0.25},
            "s": (torch.arange(5), np.arange(3.0))}


def _leaves_equal(a, b):
    from repro_torch.ckpt.checkpoint import _tree_paths
    pa, pb = _tree_paths(a), _tree_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            np.testing.assert_array_equal(x, y)


def test_roundtrip(tmp_path):
    t = _tree(0)
    save_checkpoint(str(tmp_path), 7, t)
    loaded, step = load_checkpoint(str(tmp_path), _tree(1))
    assert step == 7
    _leaves_equal(t, loaded)


def test_latest_and_gc(tmp_path):
    t = _tree(1)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=3)
    assert latest_step(str(tmp_path)) == 5
    assert available_steps(str(tmp_path)) == [3, 4, 5]


def test_partial_checkpoint_invisible(tmp_path):
    t = _tree(2)
    save_checkpoint(str(tmp_path), 1, t)
    crash = tmp_path / "step_000000002"       # shards, no manifest
    crash.mkdir()
    (crash / "leaf_00000.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 1
    _, step = load_checkpoint(str(tmp_path), t)
    assert step == 1


def test_incompatible_tree_rejected(tmp_path):
    t = _tree(3)
    save_checkpoint(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="incompatible"):
        load_checkpoint(str(tmp_path), {"only": t["a"]})
    bad = dict(t, a=torch.zeros(8, 15))
    with pytest.raises(ValueError, match="leaf a"):
        load_checkpoint(str(tmp_path), bad)


def test_gc_never_collects_pinned_step(tmp_path):
    t = _tree(4)
    save_checkpoint(str(tmp_path), 1, t)
    for s in (2, 3, 4, 5, 6):
        save_checkpoint(str(tmp_path), s, t, keep=2, pin=1)
    assert available_steps(str(tmp_path)) == [1, 5, 6]
    _, step = load_checkpoint(str(tmp_path), t, step=1)
    assert step == 1


def test_stale_tmp_swept_on_next_save(tmp_path):
    stale = tmp_path / "step_000000009.tmp"
    stale.mkdir()
    (stale / "leaf_00000.npy").write_bytes(b"partial")
    save_checkpoint(str(tmp_path), 10, _tree(5))
    assert not stale.exists()
    assert latest_step(str(tmp_path)) == 10
    stale.mkdir()
    assert sweep_tmp(str(tmp_path)) == [str(stale)]
    assert not stale.exists()


def _failing_save(tmp_path, step):
    """An async save doomed to fail: a FILE occupies its tmp path."""
    (tmp_path / f"step_{step:09d}.tmp").write_bytes(b"not a directory")
    t = _tree(6)
    h = save_checkpoint(str(tmp_path), step, t, async_=True)
    while not h.done:          # wait for the worker without acknowledging
        pass
    return t, h


def test_async_write_failure_surfaces_on_join(tmp_path):
    _, h = _failing_save(tmp_path, 3)
    assert h.error is not None
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        h.join()
    save_checkpoint(str(tmp_path / "clean"), 4, _tree(7))   # acknowledged


def test_async_write_failure_surfaces_on_next_save(tmp_path):
    t, h = _failing_save(tmp_path, 5)
    with pytest.raises(RuntimeError, match="previous async checkpoint"):
        save_checkpoint(str(tmp_path / "other"), 6, t)
    assert h.error is not None


def test_async_save_commits(tmp_path):
    t = _tree(8)
    h = save_checkpoint(str(tmp_path), 2, t, async_=True)
    assert h.join() == h == str(tmp_path / "step_000000002")
    loaded, _ = load_checkpoint(str(tmp_path), t)
    _leaves_equal(t, loaded)


def test_async_save_holds_the_values_of_its_call(tmp_path, monkeypatch):
    """An async save writes the leaves as they were when it was called,
    whatever the caller writes into its CPU tensors and arrays after."""
    import threading
    go, save = threading.Event(), np.save

    def held(*a, **k):                 # the worker waits for the edits
        go.wait(10.0)
        return save(*a, **k)

    monkeypatch.setattr(np, "save", held)
    t = _tree(9)
    want = _tree(9)
    h = save_checkpoint(str(tmp_path), 3, t, async_=True)
    t["a"].add_(1.0)
    t["b"]["c"].mul_(-2.0)
    t["s"][1][:] = -7.0
    go.set()
    h.join()
    monkeypatch.setattr(np, "save", save)
    loaded, _ = load_checkpoint(str(tmp_path), want)
    _leaves_equal(want, loaded)


# ---------------------------------------------------------------------------
# the Engine's bitwise resume
# ---------------------------------------------------------------------------

CHUNK, CHUNKS = 5, 4
THERMO = dict(dt=2e-3, lattice_gamma=2.0, spin_alpha=0.1)


def _engine(kind):
    f64 = torch.float64
    if kind == "heisenberg":
        lat = simple_cubic()
        st = init_state(lat, (4, 4, 4), generator=torch.Generator()
                        .manual_seed(2), temperature=300.0,
                        spin_init="random", dtype=f64, device="cpu")
        pot = HeisenbergDMIModel(d0=0.008, ka=0.001)
        run = dict(capacity=8, skin=0.05, diag_grid=(4, 4), pitch_bins=4)
        cfg = IntegratorConfig(midpoint=True, midpoint_iters=2, **THERMO)
    else:
        lat = b20_fege()
        st = init_state(lat, (3, 3, 3), generator=torch.Generator()
                        .manual_seed(2), temperature=300.0,
                        spin_init="random", dtype=f64, device="cpu")
        spec = NEPSpinSpec(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6,
                           hidden=16)
        params = init_params(spec, torch.Generator().manual_seed(5),
                             dtype=f64, device="cpu")
        params = params._replace(w2=0.05 * params.w2)
        pot = NEPSpinPotential(spec, params, torch.tensor([1.16, 0.0],
                                                          dtype=f64),
                               use_kernel=(kind == "nep_kernel"))
        run = dict(capacity=64, skin=0.05, use_cell_list=True,
                   cell_capacity=48)
        cfg = IntegratorConfig(**THERMO)
    return Engine(pot, cfg, st, torch.tensor(lat.masses, dtype=f64),
                  torch.tensor(lat.moments) > 0, 5.0, temperature=300.0,
                  field=(0.0, 0.0, 0.5), device="cpu",
                  observables=("energy", "kinetic", "magnetization",
                               "charge", "pitch"), **run)


def _assert_same_run(a, b, rows=slice(None)):
    for k in ("pos", "vel", "spin"):
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
    assert a.state.step == b.state.step
    assert a.n_rebuilds == b.n_rebuilds
    for k, v in b.trace.values.items():
        np.testing.assert_array_equal(a.trace.values[k][rows], v)


@pytest.mark.parametrize("kind", ["heisenberg", "nep_autograd",
                                  "nep_kernel"])
def test_engine_resume_is_bitwise(tmp_path, kind):
    full = _engine(kind)
    full.run(CHUNK * CHUNKS, torch.Generator().manual_seed(9), chunk=CHUNK,
             checkpoint_dir=str(tmp_path), checkpoint_keep=CHUNKS)
    assert full.n_rebuilds >= 1
    assert available_steps(str(tmp_path)) == [5, 10, 15, 20]
    half = CHUNK * CHUNKS // 2
    fresh = _engine(kind)
    gen = fresh.restore(str(tmp_path), step=half)
    assert fresh.state.step == half
    # the re-derived neighbor blocks are the carried ones, bit for bit
    probe = _engine(kind)
    probe.run(half, torch.Generator().manual_seed(9), chunk=CHUNK)
    for a, b in zip(probe._carry.nbh, fresh._carry.nbh):
        assert (a is None and b is None) or torch.equal(a, b)
    fresh.run(CHUNK * CHUNKS - half, gen, chunk=CHUNK)
    _assert_same_run(full, fresh, rows=slice(CHUNKS // 2, None))


def test_resume_true_picks_up_the_newest(tmp_path):
    full = _engine("heisenberg")
    full.run(20, torch.Generator().manual_seed(4), chunk=CHUNK)
    first = _engine("heisenberg")
    first.run(10, torch.Generator().manual_seed(4), chunk=CHUNK,
              checkpoint_dir=str(tmp_path))
    assert latest_step(str(tmp_path)) == 10
    again = _engine("heisenberg")          # a new process, in effect
    again.run(10, None, chunk=CHUNK, checkpoint_dir=str(tmp_path),
              resume=True)
    _assert_same_run(full, again, rows=slice(2, None))
    assert latest_step(str(tmp_path)) == 20
    with pytest.raises(ValueError, match="checkpoint_dir"):
        again.run(5, None, resume=True)
