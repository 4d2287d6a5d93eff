"""The port's scenario launchers on the CPU at their smoke sizes:
``launch/md_loop.py`` (the fused-vs-legacy MD loop of
``benchmarks/md_loop.py``), ``launch/skyrmion_nucleation.py``,
``launch/ensemble_rate.py`` and ``launch/sweep.py``'s film.

The md_loop scenario runs whole (64 atoms, every path, the telemetry run)
and writes its JSON and a runlog stamped with its ``benchmark`` record; its
gates (rebuild counts, builds during the timed runs, telemetry overhead,
``vs_autodiff``) apply at full size, on the card, where ``chip_smoke.py``
phase D runs it.  Times here are the CPU's and mean nothing for the card.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import ensemble_rate, md_loop, skyrmion_nucleation
from repro_torch.launch.sweep import build_film
from repro_torch.configs.fege_spinlattice import nucleation_ensemble_smoke
from repro_torch.kernels.nep import kernel as kern
from repro_torch.core.descriptor import NEPSpinSpec
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("md_loop")
    return md_loop.run_scenario("cpu", smoke=True, out_dir=out_dir), out_dir


def test_md_loop_runs_every_path(scenario):
    out, _ = scenario
    assert out["n_atoms"] == 64 and out["smoke"] and out["device"] == "cpu"
    cells, steps = md_loop.sizes(smoke=True)
    pots = out["potentials"]
    assert set(pots) == {"heisenberg", "nep", "nep_kernel"}
    for name, res in pots.items():
        assert res["n_steps"] == steps[name]
        labels = ("fused",) if name == "nep_kernel" else ("fused", "legacy")
        for label in labels:
            r = res[label]
            assert r["steps_per_s"] > 0 and np.isfinite(r["wall_s"])
            assert r["compiles_during_run"] == 0     # nothing is built
            assert r["rebuilds"] >= 0
        if "legacy" in res:
            assert res["speedup"] > 0
    assert pots["heisenberg"]["fused"]["rebuilds"] >= 1
    assert np.isfinite(pots["nep_kernel"]["vs_autodiff"])
    tel = out["telemetry"]
    assert tel["compiles_during_run"] == 0 and np.isfinite(
        tel["overhead_vs_fused"])


def test_md_loop_writes_json_and_stamped_runlog(scenario):
    out, out_dir = scenario
    assert json.loads((out_dir / "md_loop.json").read_text()) == json.loads(
        json.dumps(out))
    records = [json.loads(line) for line in
               (out_dir / "md_loop.jsonl").read_text().splitlines()]
    kinds = [r["event"] for r in records]
    assert kinds[0] == "run_start" and kinds[-1] == "benchmark"
    assert "run_end" in kinds
    assert records[-1]["nep_kernel"]["vs_autodiff"] == pytest.approx(
        out["potentials"]["nep_kernel"]["vs_autodiff"])


def test_md_loop_spec_has_warp_bodies():
    """The scenario's spec is compiled for both warp bodies, so on the card
    every K1 and K2 launch of its kernel path is a warp launch."""
    spec = NEPSpinSpec(**md_loop.SPEC)
    assert kern.atom_pass_body(spec) == "warp"
    assert kern.force_pass_body(spec) == "warp"


def test_nucleation_launcher_at_small_size():
    q = skyrmion_nucleation.run(True, 20, 2, 25.0, device="cpu",
                                log=lambda *a: None)
    cold = skyrmion_nucleation.run(False, 20, 1, 25.0, device="cpu",
                                   log=lambda *a: None)
    assert q.shape == (1, 2) and cold.shape == (1, 1)
    s = skyrmion_nucleation.summarize(q, cold)
    assert 0.0 <= s["nucleation_fraction"] <= 1.0
    assert len(s["thermal_max_abs_q"]) == 2


def test_ensemble_rate_reports_each_width():
    res = ensemble_rate.measure("cpu", (1, 2), iters=1)
    assert set(res) == {1, 2}
    assert res[1]["speedup_vs_sequential"] == 1.0
    for r in res.values():
        assert r["chunk_s"] > 0 and r["atom_steps_per_s"] > 0


def test_sweep_film_is_a_helix_that_fits_the_box():
    lat, ham, st = build_film(nucleation_ensemble_smoke(), device="cpu")
    assert st.pos.shape == (256, 3)
    assert torch.allclose(st.spin.norm(dim=-1), torch.ones(256))
    # 8-site textures: the spin at x and x + 8 a agree
    x = st.pos[:, 0]
    a, b = st.spin[x == 0][0], st.spin[torch.isclose(x, 8 * torch.tensor(
        lat.a, dtype=x.dtype))][0]
    assert torch.allclose(a, b, atol=1e-5)
