"""The port's benchmark drivers (``launch/{ablation,throughput,kernel_rows,
scaling,serve_rate,bench_run}.py``) on the CPU, against the reference's
``benchmarks/`` where they compute the same thing.

* ablation: B20 3^3 with a small spec, each variant's E / H (and F for the
  three that compute a force) against the reference's jitted functions,
  ``fused-2pass`` against the reference's own ``_fused_2pass`` (loaded from
  ``benchmarks/ablation.py``), both on the reference's table (2e-5 of the
  largest |value|, f32).  The 2-pass row's partial force ``f`` is a sum of
  per-slot terms that nearly cancel: in f32 each side lies ~1.2e-4 of
  max |f| from its own f64 value, so ``f`` is held against the reference's
  function at f64 (a subprocess, 1e-10); the max coordination of the
  driver's own table;
* throughput: the atom counts and the parameter count of a smoke run;
* kernel rows: the fused path (plain K1 / K2 on the CPU) against the
  reference's ``nep_energy_forces_field`` (2e-5);
* one ``bench_run --smoke`` of ``scaling`` and ``serve`` into a temporary
  ``--out``: the drift invariant and 0 builds on 2 gloo ranks, every serve
  job done with a consistent ledger, nothing written outside ``--out``;
* the registry: an unknown ``--only`` exits naming it; a failing driver
  (each runs in a child process) leaves the others running and the run
  failing; where each driver's JSON lies.

Times here are the CPU's and say nothing of the card.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import potential as jpot
from repro.core.descriptor import NEPSpinSpec as JSpec
from repro.kernels.nep.ops import nep_energy_forces_field as j_nep_eff
from repro.md import neighbor as jnb
from repro.md.lattice import b20_fege as j_b20
from repro.md.state import init_state as j_init_state
from repro.utils.tree import tree_count as j_tree_count
from repro_torch.core.descriptor import NEPSpinSpec
from repro_torch.core.potential import params_from_jax
from repro_torch.launch import (ablation, bench_run, kernel_rows, scaling,
                                throughput)
from repro_torch.md.neighbor import NeighborTable
from repro_torch.md.state import state_from_numpy
from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(l_max=2, n_ang=2, n_rad=4, n_spin=2, basis_size=6)
TOL = 2e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _reference_ablation():
    """``benchmarks/ablation.py`` loaded by its path (its module imports
    ``benchmarks.common``, so the repository root goes on the path)."""
    sys.path.insert(0, str(ROOT))
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_ablation", ROOT / "benchmarks" / "ablation.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(ROOT))
    return mod


@pytest.fixture(scope="module")
def b20():
    """The reference's B20 3^3 state at 300 K, its small-spec parameters,
    its capacity-96 table and the max coordination, with the port's copies
    of the same numbers."""
    st = j_init_state(j_b20(), (3, 3, 3), temperature=300.0,
                      key=jax.random.PRNGKey(0), dtype=jnp.float32)
    jspec = JSpec(**SMALL)
    jparams = jpot.init_params(jspec, jax.random.PRNGKey(1),
                               dtype=jnp.float32)
    jtab = jnb.dense_neighbor_table(st.pos, st.box, jspec.cutoff, 96)
    max_coord = int(jtab.mask.sum(1).max())
    tst = state_from_numpy(st.pos, st.vel, st.spin, st.types, st.box,
                           device="cpu")
    tparams = params_from_jax([np.asarray(x) for x in jparams],
                              device="cpu")
    ttab = NeighborTable(idx=torch.as_tensor(np.asarray(jtab.idx)),
                         mask=torch.as_tensor(np.asarray(jtab.mask)),
                         r0=tst.pos, cutoff=float(jtab.cutoff))
    return dict(st=st, spec=jspec, params=jparams, tab=jtab,
                max_coord=max_coord, tst=tst, tspec=NEPSpinSpec(**SMALL),
                tparams=tparams, ttab=ttab)


def test_ablation_variants_match_the_reference(b20):
    st, spec, params, tab = b20["st"], b20["spec"], b20["params"], b20["tab"]
    types, box = st.types, st.box

    def e_of(p, s):
        return jpot.energy(spec, params, p, s, types, tab, box)

    ref = {
        "unfused-3pass": jax.jit(lambda p, s: (
            e_of(p, s), -jax.grad(lambda q: e_of(q, s))(p),
            -jax.grad(lambda q: e_of(p, q))(s)))(st.pos, st.spin),
        "fused-autodiff": jax.jit(lambda p, s: jpot.energy_forces_field(
            spec, params, p, s, types, tab, box))(st.pos, st.spin),
        "fused-2pass": jax.jit(lambda p, s: _reference_ablation()
                               ._fused_2pass(spec, params, p, s, types, tab,
                                             box))(st.pos, st.spin),
    }
    tst, ttab = b20["tst"], b20["ttab"]
    calls = ablation.variants(b20["tspec"], b20["tparams"], tst, ttab, ttab)
    assert list(calls) == ["unfused-3pass", "fused-autodiff", "fused-2pass",
                           "pruned-M"]
    for name, want in ref.items():
        got = calls[name](tst.pos, tst.spin)
        # E and H of every variant; F of the two that compute the force
        # (the 2-pass's partial f: test_fused_2pass_f_matches_at_f64)
        for what, g, w in zip("EFH", got, want):
            if name == "fused-2pass" and what == "F":
                continue
            err = _rel(g.detach().numpy(), w)
            assert err < TOL, (name, what, err)
    # pruned-M is fused-autodiff on the table cut to the max coordination
    jtight = jnb.dense_neighbor_table(st.pos, st.box, spec.cutoff,
                                      b20["max_coord"])
    want = jpot.energy_forces_field(spec, params, st.pos, st.spin, types,
                                    jtight, box)
    tight = NeighborTable(idx=torch.as_tensor(np.asarray(jtight.idx)),
                          mask=torch.as_tensor(np.asarray(jtight.mask)),
                          r0=tst.pos, cutoff=float(jtight.cutoff))
    got = ablation.variants(b20["tspec"], b20["tparams"], tst, ttab,
                            tight)["pruned-M"](tst.pos, tst.spin)
    for what, g, w in zip("EFH", got, want):
        assert _rel(g.numpy(), w) < TOL, ("pruned-M", what)


_F64_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, sys.argv[2])
from benchmarks.ablation import _fused_2pass
from repro.core import potential as jpot
from repro.core.descriptor import NEPSpinSpec
from repro.md import neighbor as jnb
from repro.md.lattice import b20_fege
from repro.md.state import init_state
st = init_state(b20_fege(), (3, 3, 3), temperature=300.0,
                key=jax.random.PRNGKey(0), dtype=jnp.float64)
spec = NEPSpinSpec(**eval(sys.argv[3]))
params = jpot.init_params(spec, jax.random.PRNGKey(1), dtype=jnp.float32)
params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), params)
tab = jnb.dense_neighbor_table(st.pos, st.box, spec.cutoff, 96)
e, f, h = jax.jit(lambda p, s: _fused_2pass(spec, params, p, s, st.types,
                                            tab, st.box))(st.pos, st.spin)
np.savez(sys.argv[1], e=e, f=f, h=h, idx=tab.idx, mask=tab.mask,
         pos=st.pos, vel=st.vel, spin=st.spin, types=st.types, box=st.box,
         cutoff=tab.cutoff, **{f"p{i}": np.asarray(x)
                               for i, x in enumerate(params)})
"""


def test_fused_2pass_f_matches_at_f64(tmp_path):
    """The port's ``fused_2pass`` against the reference's ``_fused_2pass``
    at f64 (the reference in a subprocess, x64 on), from the reference's
    state, weights (its f32 draw, widened) and table: E, f and h within
    1e-10 of the largest |value|."""
    from torch_one_thread import XLA_ONE_THREAD
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=XLA_ONE_THREAD)
    out = tmp_path / "ref.npz"
    r = subprocess.run([sys.executable, "-c", _F64_SCRIPT, str(out),
                        str(ROOT), repr(SMALL)], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ref = np.load(out)
    f64 = torch.float64
    st = state_from_numpy(ref["pos"], ref["vel"], ref["spin"], ref["types"],
                          ref["box"], dtype=f64, device="cpu")
    params = params_from_jax([ref[f"p{i}"] for i in range(8)], dtype=f64,
                             device="cpu")
    tab = NeighborTable(idx=torch.as_tensor(ref["idx"]),
                        mask=torch.as_tensor(ref["mask"]), r0=st.pos,
                        cutoff=float(ref["cutoff"]))
    got = ablation.fused_2pass(NEPSpinSpec(**SMALL), params, st.pos,
                               st.spin, st.types, tab, st.box)
    for what, g, key in zip("EFH", got, "efh"):
        assert _rel(g.numpy(), ref[key]) < 1e-10, what


def test_fused_2pass_is_not_the_force(b20):
    """The 2-pass row's f leaves out the neighbours' reactions (as the
    reference's does): it differs from F by far more than rounding."""
    tst, ttab = b20["tst"], b20["ttab"]
    calls = ablation.variants(b20["tspec"], b20["tparams"], tst, ttab, ttab)
    _, f, _ = calls["fused-2pass"](tst.pos, tst.spin)
    _, force, _ = calls["fused-autodiff"](tst.pos, tst.spin)
    assert _rel(f.numpy(), force.numpy()) > 1e-2


def test_ablation_max_coordination_is_the_reference(b20):
    *_, max_coord = ablation.setup("cpu", 3)
    assert max_coord == b20["max_coord"]


def test_throughput_counts_match_the_reference(monkeypatch):
    monkeypatch.setenv("BENCH_SMOKE", "1")
    out = throughput.run("cpu", kernel=True)
    assert out["cells"] == list(throughput.SMOKE_CELLS)
    want_n = {str(c): int(j_init_state(j_b20(), (c,) * 3).n_atoms)
              for c in throughput.SMOKE_CELLS}
    for key in ("autodiff", "kernel"):
        got = {c: r["n_atoms"] for c, r in out[key]["sizes"].items()}
        assert got == want_n
        assert out[key]["largest_n"] == max(want_n.values())
        assert out[key]["tts_ratio_largest_over_smallest"] > 0
    jparams = jpot.init_params(JSpec(**throughput.SPEC),
                               jax.random.PRNGKey(0), dtype=jnp.float32)
    assert out["n_params"] == j_tree_count(jparams)
    # the small spec with hidden 32 has warp bodies; no launch on the CPU
    assert out["kernel"]["bodies"] == {"K1": "warp", "K2": "warp"}
    assert all(v["total"] == 0 for v in out["kernel"]["launches"].values())
    assert len(out["rows"]) == 2 * (len(throughput.SMOKE_CELLS) + 1)


def test_kernel_rows_fused_path_matches_the_reference():
    """The NEP rows' fused evaluation (plain K1 / K2 here) at the rows'
    production spec, B20 3^3, on the driver's own table, against the
    reference's ``nep_energy_forces_field`` with the same weights."""
    from repro_torch.kernels.nep.ops import nep_energy_forces_field
    spec, _, tst, ttab = kernel_rows.nep_setup("cpu", 3)
    jspec = JSpec()
    jparams = jpot.init_params(jspec, jax.random.PRNGKey(1),
                               dtype=jnp.float32)
    params = params_from_jax([np.asarray(x) for x in jparams], device="cpu")
    st = j_init_state(j_b20(), (3, 3, 3), dtype=jnp.float32)
    assert np.array_equal(tst.pos.numpy(), np.asarray(st.pos))
    jtab = jnb.dense_neighbor_table(st.pos, st.box, jspec.cutoff,
                                    kernel_rows.CAPACITY)
    want = j_nep_eff(jspec, jparams, st.pos, jnp.asarray(tst.spin.numpy()),
                     st.types, jtab, st.box)
    got = nep_energy_forces_field(spec, params, tst.pos, tst.spin, tst.types,
                                  ttab, tst.box)
    for what, g, w in zip("EFH", got, want):
        assert _rel(g.numpy(), w) < TOL, what


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def _tree_state(root: pathlib.Path) -> dict:
    """The repository's top-level entries and the drivers' default output
    folders, with their modification times."""
    paths = list(root.iterdir()) + [root / "build" / "bench",
                                    root / "build" / "md_loop"]
    return {str(p): p.stat().st_mtime_ns if p.exists() else None
            for p in paths if p.name not in ("__pycache__", ".pytest_cache")}


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "out"
    before = _tree_state(ROOT)
    res = bench_run.main(["--only", "scaling,serve", "--smoke", "--strict",
                          "--device", "cpu", "--out", str(out)])
    return res, out, before, _tree_state(ROOT)


def test_smoke_run_writes_only_under_out(smoke_run):
    res, out, before, after = smoke_run
    assert res["ok"] and list(res["drivers"]) == ["scaling", "serve"]
    assert after == before
    assert {p.name for p in out.iterdir()} >= {"scaling.json",
                                               "serve_rate.json",
                                               "serve_rate"}


def test_smoke_scaling_holds_the_drift_invariant(smoke_run):
    _, out, _, _ = smoke_run
    res = json.loads((out / "scaling.json").read_text())
    assert res["smoke"] and list(res["sizes"]) == ["floor"]
    runs = res["sizes"]["floor"]["sharded"]
    assert list(runs) == [str(n) for n in scaling.SMOKE_RANKS] == ["2"]
    r = runs["2"]
    assert r["backend"] == "gloo" and r["atoms_per_rank"] == 64
    assert r["drift_pos_exchanges_per_step"] == 1
    assert r["halo_counts"]["drift-pos"] == r["steps"] == scaling.CHUNK
    assert r["compiles_during_run"] == 0
    assert "nep_kernel" not in res          # full runs only
    assert res["provenance"]["device_name"] == "cpu"


def test_smoke_serve_finishes_every_job(smoke_run):
    from repro_torch.serve.accounting import Accounting
    _, out, _, _ = smoke_run
    res = json.loads((out / "serve_rate.json").read_text())
    assert res["n_jobs"] == 4 and res["smoke"]
    assert res["drain"]["steady_compiles"] == 0
    assert res["recovery"]["deduplicated"] + res["recovery"]["resumed"] >= 1
    for name in ("plain", "wal", "rec"):
        acct = Accounting.from_runlog(out / "serve_rate" / f"{name}.jsonl")
        assert acct.consistent(), name


def test_registry_order_and_driver_arguments():
    assert list(bench_run.REGISTRY) == [
        "kernels", "ablation", "throughput", "scaling", "accuracy",
        "ensemble", "serve", "md_loop"]
    for module in bench_run.REGISTRY.values():
        assert (ROOT / "src" / "repro_torch" / "launch"
                / f"{module}.py").exists(), module
    args = bench_run.bc.parse(bench_run.bc.add_args(
        __import__("argparse").ArgumentParser()),
        ["--device", "cpu", "--out", "o", "--smoke"])
    # the switches reach the drivers through the environment
    assert bench_run.driver_args("md_loop", args) == [
        "--device", "cpu", "--out", os.path.join("o", "md_loop")]
    assert bench_run.driver_args("throughput", args)[-1] == "--kernel"
    assert bench_run.result_path("o", "md_loop") == pathlib.Path(
        "o", "md_loop", "md_loop.json")
    assert bench_run.result_path("o", "serve") == pathlib.Path(
        "o", "serve_rate.json")


def test_unknown_only_names_the_registry():
    with pytest.raises(SystemExit, match="registry: kernels, ablation"):
        bench_run.main(["--only", "kernels,nope", "--device", "cpu"])


def test_a_raising_driver_leaves_the_others_running(monkeypatch, tmp_path,
                                                    capsys):
    """The first driver's child exits nonzero (an unknown flag), the next
    one still runs (``--help``: exit 0) and the run fails naming the
    first; both children run ``launch/ci_smoke.py``, which starts in a
    tenth of a second (it imports no torch)."""
    flags = {"kernels": ["--no-such-flag"], "serve": ["--help"]}
    monkeypatch.setitem(bench_run.REGISTRY, "kernels", "ci_smoke")
    monkeypatch.setitem(bench_run.REGISTRY, "serve", "ci_smoke")
    monkeypatch.setattr(bench_run, "driver_args",
                        lambda name, args: flags[name])
    res = bench_run.main(["--only", "serve,kernels", "--device", "cpu",
                          "--out", str(tmp_path)])
    assert res["failed"] == ["kernels"] and not res["ok"]
    assert list(res["drivers"]) == ["kernels", "serve"]
    assert res["drivers"]["serve"]["rc"] == 0
    assert res["drivers"]["kernels"]["rc"] == 2
    assert "FAILED: ['kernels']" in capsys.readouterr().err


def test_the_run_exits_1_naming_each_failure(tmp_path):
    """Asked for a card this host does not have, every driver raises; the
    run still goes through both and exits 1."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.bench_run",
                        "--only", "kernels,ablation", "--device", "cuda",
                        "--out", str(tmp_path)], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1
    assert "FAILED: ['kernels', 'ablation']" in r.stderr
    assert r.stderr.count("is_available() is False") == 2
