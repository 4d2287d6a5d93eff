"""LM training of the ssm and hybrid families in the port against the JAX
package.

For ``mamba2-smoke`` and ``zamba2-smoke`` both packages take the same
weights (``params_from_jax`` of the reference's ``init_params(PRNGKey(0),
tp=2)``) and the same batch (``synthetic_batches`` at S = 32: two SSD
chunks of 16) at f32: the loss of ``make_loss_fn(cfg)`` (remat on, loss
chunks of 12 rows) within 2e-5 relative and every leaf's gradient within
1e-4 of its max |ref| against ``jax.value_and_grad`` of the reference's,
as ``tests/test_torch_lm_train.py`` holds the attention families.  The
port's Mamba-2 blocks run the SSD kernels' autograd Function and Zamba2's
shared block the flash kernels' Function; on CPU tensors both take their
plain versions.  Then remat, the kernels' calls a step, and the launchers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.data.tokens import synthetic_batches, to_tensors
from repro_torch.kernels.attention import kernel as fa
from repro_torch.kernels.ssd import kernel as ssd
from repro_torch.launch import train as train_launch
from repro_torch.launch import train_lm as train_lm_launch
from repro_torch.models import lm
from repro_torch.utils.tree import tree_count, tree_leaves
from torch_one_thread import one_torch_thread  # noqa: F401

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
B, S = 2, 32
XENT_CHUNK = 12


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _requires_grad(tree):
    return {k: _requires_grad(v) if isinstance(v, dict) else
            v.requires_grad_(True) for k, v in tree.items()}


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _loss(cfg, jparams, batch, remat=True):
    params = _requires_grad(lm.params_from_jax(cfg, _tree(jparams),
                                               device="cpu"))
    loss = lm.make_loss_fn(cfg, remat=remat, xent_chunk=XENT_CHUNK)(
        params, to_tensors(batch, "cpu"))
    loss.backward()
    return float(loss.detach()), params


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=2)
    batch = next(synthetic_batches(cfg, B, S, seed=3))
    assert S // cfg.ssm.chunk == 2
    j_loss, j_grads = jax.jit(jax.value_and_grad(jlm.make_loss_fn(
        jcfg, xent_chunk=XENT_CHUNK)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, params = _loss(cfg, jparams, batch)
    return dict(arch=arch, cfg=cfg, jparams=jparams, batch=batch,
                j_loss=float(j_loss), j_grads=j_grads, params=params,
                loss=loss)


def test_loss_matches_jax(case):
    assert abs(case["loss"] - case["j_loss"]) < 2e-5 * abs(case["j_loss"])


def test_grads_match_jax(case):
    """Every leaf (the stacked Mamba-2 layers' projections, convolution,
    a_log, dt_bias, d_skip and norm; zamba2's shared attention and MLP; the
    embedding and head) within 1e-4 of its max |ref|."""
    flat = jax.tree_util.tree_flatten_with_path(case["j_grads"])[0]
    assert len(flat) == len(tree_leaves(case["params"]))
    worst = {}
    for path, g in flat:
        got = _leaf(case["params"], path).grad
        assert got is not None, path
        worst[jax.tree_util.keystr(path)] = _rel(got.numpy(), np.asarray(g))
    assert max(worst.values()) < 1e-4, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]


def test_remat_changes_no_number(case):
    """Per-layer recomputation (the SSD Function runs its forward twice)
    gives the same loss and gradients."""
    loss, params = _loss(case["cfg"], case["jparams"], case["batch"],
                         remat=False)
    assert loss == case["loss"]
    for a, b in zip(tree_leaves(params), tree_leaves(case["params"])):
        assert torch.allclose(a.grad, b.grad, rtol=0,
                              atol=1e-6 * float(b.grad.abs().max()) + 1e-30)


def test_training_runs_the_kernels_calls(case, monkeypatch):
    """With remat, the SSD chunk step's forward twice per Mamba-2 layer
    (the forward and its recomputation) and its backward once; zamba2's
    shared block, not rematted, one flash forward and one backward per
    call."""
    calls = dict.fromkeys(("ssd_fwd", "ssd_bwd", "fa_fwd", "fa_bwd"), 0)

    def counted(key, real):
        def fn(*args, **kw):
            calls[key] += 1
            return real(*args, **kw)
        return fn
    for mod, name, key in ((ssd, "ssd_chunks", "ssd_fwd"),
                           (ssd, "ssd_chunks_bwd", "ssd_bwd"),
                           (fa, "flash_attention_fwd", "fa_fwd"),
                           (fa, "flash_attention_bwd", "fa_bwd")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    cfg = case["cfg"]
    _loss(cfg, case["jparams"], case["batch"])
    shared = (cfg.n_layers // cfg.shared_every if cfg.family == "hybrid"
              else 0)
    assert calls == {"ssd_fwd": 2 * cfg.n_layers, "ssd_bwd": cfg.n_layers,
                     "fa_fwd": shared, "fa_bwd": shared}


def _args(tmp, **kw):
    base = ["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--steps", "3", "--lr", "3e-2",
            "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir", str(tmp)]
    for k, v in kw.items():
        base += [f"--{k}", str(v)]
    return train_launch.parse_args(base)


def test_train_launcher_trains_mamba2_and_resumes_bitwise(tmp_path):
    """``launch/train.py --arch mamba2-2.7b --smoke --device cpu``: 3 steps
    with a falling loss, checkpoints at steps 1 and 2; with step 2's
    removed, a relaunch resumes at step 2 and ends bitwise where the
    uninterrupted run did."""
    import shutil
    run = train_launch.train_lm(_args(tmp_path / "a"))
    losses = [r["loss"] for r in run["rows"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(r["grad_norm"]) for r in run["rows"])
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_000000001", "step_000000002"]
    shutil.rmtree(tmp_path / "a" / "step_000000002")
    again = train_launch.train_lm(_args(tmp_path / "a"))
    assert again["start"] == 2 and [r["step"] for r in again["rows"]] == [2]
    assert (again["rows"][0]["loss"], again["rows"][0]["grad_norm"]) == (
        run["rows"][2]["loss"], run["rows"][2]["grad_norm"])
    for a, b in zip(tree_leaves(run["state"].params),
                    tree_leaves(again["state"].params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_lm_launcher_scales_the_family(arch, monkeypatch):
    """``launch/train_lm.py``: the smoke config at ~100M-parameter widths,
    its family kept (the SSD block; zamba2's shared attention at 8 heads
    of 64), trained two steps through the launcher's own path at a small
    width."""
    cfg = train_lm_launch.hundred_m_config(arch)
    assert (cfg.family, cfg.d_model, cfg.n_layers, cfg.vocab) == (
        configs.get_smoke(arch).family, 512, 8, 32000)
    assert cfg.ssm == configs.get_smoke(arch).ssm
    if cfg.family == "hybrid":
        assert (cfg.n_heads, cfg.kv_heads, cfg.hd) == (8, 4, 64)
    monkeypatch.setattr(train_lm_launch, "SCALE", dict(
        d_model=64, n_layers=2, d_ff=128, vocab=512))
    out = train_lm_launch.main(["--arch", arch, "--steps", "2", "--batch",
                                "2", "--seq", "32", "--device", "cpu"])
    assert out["cfg"].d_model == 64 and len(out["rows"]) == 2
    assert all(np.isfinite(r["loss"]) for r in out["rows"])


def test_train_depth_keeps_every_layer_of_both():
    """At the card's 60 GiB training budget (16 bytes a parameter) both
    2.7B archs keep every layer: ~2.8 B parameters for mamba2 (64 layers),
    ~2.4 B for zamba2 (54 layers and the shared block)."""
    got = {}
    for arch in ARCHS:
        full = configs.get(arch)
        cfg, gib = train_launch.train_depth(full, 60.0)
        assert cfg.n_layers == full.n_layers and gib <= 60.0
        got[arch] = tree_count(lm.abstract_params(cfg, tp=1))
    assert 2.7e9 < got["mamba2-2.7b"] < 2.9e9, got
    assert 2.3e9 < got["zamba2-2.7b"] < 2.5e9, got
