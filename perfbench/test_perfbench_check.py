"""The check that decides ``correct``, driven through the rest of a run on
the CPU (the rehearsal's 4^3 box, the kernels' plain versions): a sound run
passes, and the control and each fault a cell can have fail it."""
import functools
import time

import pytest
import torch

from perfbench import run
from perfbench.harness import manifest, runner


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and the rehearsal's small tensors gain nothing from more."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def rehearse(cell: dict, seed: int, control: bool = False, hook=None,
             trace: int = 0) -> dict:
    argv = ["--workload", cell["workload"]["name"], "--seed", str(seed),
            "--seconds", "0", "--trace", str(trace), "--rehearse"] + (
                ["--control"] if control else [])
    return runner.run(cell, run.parse(argv), time.perf_counter(), hook=hook)


def sharded_cell() -> dict:
    """The Sharded plan's mix on four ranks (``plans/sharded.py``), which
    ``BENCHMARK.json`` leaves out for its spread (``PERF.md``), with the
    Sharded plan's own metrics."""
    cell = manifest.compose(
        {"name": "fege-prod-sharded-4x262k", "config": "nep-spin-prod",
         "traffic": "sharded-64x64x32c-300k", "chips": 4},
        manifest.load())
    cell["metrics"]["per_layer"] = [
        {"name": n, "unit": u} for n, u in (("halo_mb_per_step", "MB/step"),
                                            ("comm_ms_per_step", "ms/step"))]
    return cell


def _frozen_step(patch):
    """A step that returns its state unchanged."""
    import repro_torch.md.engine as engine
    make = engine.make_fused_step

    def build(*a, **k):
        make(*a, **k)

        def step(state, ff, nbh, *args, **kw):
            return state._replace(step=state.step + 1), ff, nbh
        return step
    patch(engine, "make_fused_step", build)


def _half_the_atoms(patch):
    """Forces and fields of the second half of the atoms left out."""
    from repro_torch.core.potential import NEPSpinPotential
    compute = NEPSpinPotential.compute

    def half(self, nbh, spin, types, field=None):
        e, f, h = compute(self, nbh, spin, types, field)
        n = f.shape[-2]
        f, h = f.clone(), h.clone()
        f[..., n // 2:, :] = 0.0
        h[..., n // 2:, :] = 0.0
        return e, f, h
    patch(NEPSpinPotential, "compute", half)


def _altered_force(patch):
    """One force component altered where K2 produces it."""
    import repro_torch.kernels.nep.ops as ops
    force_pass = ops.nep_force_pass

    def altered(*a, **k):
        f, h2 = force_pass(*a, **k)
        f = f.clone()
        f[..., 0, 0] += 0.05
        return f, h2
    patch(ops, "nep_force_pass", altered)


def _k2_output(change):
    """K2 on the Sharded plan's slots (``kernels/nep/kernel.py``, which the
    plan's evaluator calls), its force and field passed through
    ``change``."""
    def plant(patch):
        import repro_torch.kernels.nep.kernel as kernel
        force_pass = kernel.nep_force_pass

        def changed(*a, **k):
            f, h2 = force_pass(*a, **k)
            return change(f.clone(), h2.clone())
        patch(kernel, "nep_force_pass", changed)
    return plant


def _slots_half(f, h2):
    n = f.shape[-2]
    f[..., n // 2:, :] = 0.0
    h2[..., n // 2:, :] = 0.0
    return f, h2


def _slot_altered(f, h2):
    f[..., 0, 0] += 0.05
    return f, h2


def _no_exchange(patch):
    """Every halo exchange between the cards left out: each rank wraps its
    own slab as if it held the whole box."""
    import repro_torch.parallel.halo as halo
    patch(halo, "_communicates", lambda ax: False)


FAULTS = {"state_unchanged": _frozen_step, "half_left_out": _half_the_atoms,
          "answer_altered": _altered_force}
SHARDED_FAULTS = {"state_unchanged": _frozen_step,
                  "half_left_out": _k2_output(_slots_half),
                  "answer_altered": _k2_output(_slot_altered),
                  "exchange_left_out": _no_exchange}
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def plant(fault: str):
    """Plant a fault of :data:`SHARDED_FAULTS` in this process (a rank's)."""
    SHARDED_FAULTS[fault](setattr)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = rehearse(manifest.cell(workload), 11)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails(workload):
    out = rehearse(manifest.cell(workload), 12, control=True)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails_the_flat_cell(fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    out = rehearse(manifest.cell("fege-prod-262k"), 13)
    assert not out["correct"], out["check"]


def test_a_sound_run_over_four_ranks_is_correct():
    out = rehearse(sharded_cell(), 11, trace=1)
    assert out["correct"], out["check"]
    assert out["device"]["count"] == 4 and out["attempted"] > 0
    assert out["metrics"]["halo_mb_per_step"]["value"] > 0
    assert "comm_ms_per_step" not in out["metrics"]    # no card, no trace


@pytest.mark.parametrize("fault", sorted(SHARDED_FAULTS))
def test_each_fault_fails_a_cell_over_cards(fault):
    out = rehearse(sharded_cell(), 13, hook=functools.partial(plant, fault))
    assert not out["correct"], out["check"]


@pytest.mark.card
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, str(run.ROOT / "perfbench" / "run.py"),
         "--workload", "fege-prod-262k", "--seed", "15", "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=run.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    import json
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
