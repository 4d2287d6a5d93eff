"""LM training in the port (the zoo's attention families) against the JAX
package.

For the smoke config of each of the eight attention archs both packages
take the same weights (``params_from_jax`` of the reference's
``init_params(PRNGKey(0), tp=2)``) and the same batch (the two
``synthetic_batches``, bitwise equal) at f32: the loss of
``make_loss_fn(cfg)`` (remat on, loss chunks of 12 rows so the last one is
ragged) within 2e-5 relative and every leaf's gradient within 1e-4 of its
max |ref| against ``jax.value_and_grad`` of the reference's.  The port's
attention runs the flash kernels' autograd Function, whose plain versions
serve CPU tensors.  Then the training substrate: the ports of
``tests/test_train.py``'s loss-decrease and accumulation tests, three
AdamW steps against the reference's ``make_train_step``, the data
pipeline, int8 error feedback (with the property of
``tests/test_properties.py``), the ``"save_collectives"`` policy and the
launchers with a checkpoint resume (the ssm and hybrid families train in
``tests/test_torch_ssm_train.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import configs as jconfigs
from repro.data.tokens import synthetic_batches as j_batches
from repro.models import lm as jlm
from repro.parallel.compression import Int8ErrorFeedback as JInt8EF
from repro.train.optimizer import cosine_schedule as j_cosine
from repro.train.train_step import init_train_state as j_init_state
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.data.tokens import synthetic_batches, to_tensors
from repro_torch.kernels.attention import kernel as tkern
from repro_torch.launch import train as train_launch
from repro_torch.launch import train_lm as train_lm_launch
from repro_torch.models import lm
from repro_torch.models import transformer as tfm
from repro_torch.parallel.compression import Int8ErrorFeedback
from repro_torch.train.optimizer import cosine_schedule
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.tree import tree_leaves, tree_unflatten
from torch_one_thread import one_torch_thread  # noqa: F401

ARCHS = ["h2o-danube-3-4b", "qwen2-7b", "minitron-4b", "starcoder2-3b",
         "pixtral-12b", "deepseek-v3-671b", "moonshot-v1-16b-a3b",
         "seamless-m4t-large-v2"]
B = 2
XENT_CHUNK = 12


def _seq(cfg):
    """Positions a batch row holds: 40 for a window arch (2.5 windows of
    its smoke 16, so training masks keys), 32 source frames (8 target
    tokens) for the encoder-decoder, else 16."""
    if cfg.sliding_window:
        return 40
    return 32 if cfg.family == "audio" else 16


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


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=2)
    batch = next(synthetic_batches(cfg, B, _seq(cfg), seed=3))
    j_loss, j_grads = jax.jit(jax.value_and_grad(jlm.make_loss_fn(
        jcfg, xent_chunk=XENT_CHUNK)))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = _requires_grad(lm.params_from_jax(cfg, _tree(jparams),
                                               device="cpu"))
    loss = lm.make_loss_fn(cfg, xent_chunk=XENT_CHUNK)(
        params, to_tensors(batch, "cpu"))
    loss.backward()
    return dict(arch=arch, cfg=cfg, jparams=jparams, batch=batch,
                j_loss=float(j_loss), j_grads=j_grads, params=params,
                loss=float(loss.detach()))


def test_loss_matches_jax(case):
    assert abs(case["loss"] - case["j_loss"]) < 2e-5 * abs(case["j_loss"])


def test_grads_match_jax(case):
    """Every leaf (stacked layers, experts, routers, MLA, the encoder and
    the decoder alike) within 1e-4 of its max |ref|."""
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
    """Per-layer recomputation gives the same loss and gradients."""
    cfg = case["cfg"]
    params = _requires_grad(lm.params_from_jax(cfg, _tree(case["jparams"]),
                                               device="cpu"))
    loss = lm.make_loss_fn(cfg, remat=False, xent_chunk=XENT_CHUNK)(
        params, to_tensors(case["batch"], "cpu"))
    loss.backward()
    assert float(loss.detach()) == case["loss"]
    for a, b in zip(tree_leaves(params), tree_leaves(case["params"])):
        assert torch.allclose(a.grad, b.grad, rtol=0,
                              atol=1e-6 * float(b.grad.abs().max()) + 1e-30)


def test_training_runs_flash_forward_and_backward(case, monkeypatch):
    """With remat, one flash forward per attention in the forward and one
    more in its recomputation, and one backward per attention."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tkern.flash_attention_fwd, tkern.flash_attention_bwd

    def fwd(*args, **kwargs):
        calls["fwd"] += 1
        assert kwargs.get("return_lse")
        return real_fwd(*args, **kwargs)

    def bwd(*args, **kwargs):
        calls["bwd"] += 1
        return real_bwd(*args, **kwargs)
    monkeypatch.setattr(tkern, "flash_attention_fwd", fwd)
    monkeypatch.setattr(tkern, "flash_attention_bwd", bwd)
    cfg = case["cfg"]
    params = _requires_grad(lm.params_from_jax(cfg, _tree(case["jparams"]),
                                               device="cpu"))
    lm.make_loss_fn(cfg, xent_chunk=XENT_CHUNK)(
        params, to_tensors(case["batch"], "cpu")).backward()
    n = (cfg.encoder_layers + 2 * cfg.n_layers if cfg.family == "audio"
         else cfg.n_layers)
    assert calls == {"fwd": 2 * n, "bwd": n}


# ---------------------------------------------------------------------------
# the training substrate
# ---------------------------------------------------------------------------

def _clone(params):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in params.items()}


def test_tiny_lm_loss_decreases():
    """The port of ``tests/test_train.py::test_tiny_lm_loss_decreases``."""
    cfg = configs.get_smoke("qwen2-7b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), tp=1,
                            device="cpu")
    state = init_train_state(params)
    loss_fn = lm.make_loss_fn(cfg, remat=False, xent_chunk=64)
    step = make_train_step(loss_fn, lambda s: cosine_schedule(
        s, peak_lr=1e-2, warmup=5, total=60), accum=1)
    gen = synthetic_batches(cfg, 4, 32, seed=0)
    losses = []
    for _ in range(45):
        state, m = step(state, to_tensors(next(gen), "cpu"))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:5]) - 0.3, \
        f"no learning: {losses[:3]} -> {losses[-3:]}"


def test_grad_accumulation_equivalence():
    """The port of ``tests/test_train.py::test_grad_accumulation_
    equivalence``: accum=4 over a batch matches accum=1 on it."""
    cfg = configs.get_smoke("starcoder2-3b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), tp=1,
                            device="cpu")
    loss_fn = lm.make_loss_fn(cfg, remat=False, xent_chunk=32)
    batch = to_tensors(next(synthetic_batches(cfg, 8, 16, seed=1)), "cpu")
    outs = []
    for accum in (1, 4):
        state = init_train_state(_clone(params))
        step = make_train_step(loss_fn, lambda s: 1e-3, accum=accum)
        new_state, m = step(state, batch)
        assert new_state.step == 1 and new_state.opt.count == 1
        outs.append((float(m["loss"]), tree_leaves(new_state.params)))
    assert abs(outs[0][0] - outs[1][0]) < 2e-3
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4)


def test_three_adamw_steps_match_jax():
    """Three steps of ``make_train_step`` (accum 2, cosine schedule) on the
    reference's weights and batches: each step's loss, learning rate and
    gradient norm within 1e-5 relative; the parameters after each step
    within 1e-6 plus 1 % of the summed step sizes of the reference's.
    AdamW divides each gradient by its own magnitude, so where the first
    step's gradient is below 1e-5 of its leaf's largest (under the 1e-4
    bar the gradients are held to) the packages' last-bit differences set
    the update's direction: such entries (one of moonshot's 2,048
    ``sh_wo`` entries, |g| ~ 1e-9) are held to the most AdamW can move
    any entry, 2 x the summed step sizes."""
    arch = "moonshot-v1-16b-a3b"
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1), tp=2)
    params = lm.params_from_jax(cfg, _tree(jparams), device="cpu")

    def sched(s):
        return j_cosine(s, peak_lr=1e-3, warmup=2, total=3)
    j_step = jax.jit(j_make_train_step(jlm.make_loss_fn(
        jcfg, remat=False, xent_chunk=XENT_CHUNK), sched, accum=2))
    step = make_train_step(lm.make_loss_fn(cfg, remat=False,
                                           xent_chunk=XENT_CHUNK),
                           lambda s: cosine_schedule(
                               s, peak_lr=1e-3, warmup=2, total=3), accum=2)
    j_state, state = j_init_state(jparams), init_train_state(params)
    gen = synthetic_batches(cfg, 4, 16, seed=5)
    lr_sum, tiny = 0.0, None
    for i in range(3):
        batch = next(gen)
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state, m = step(state, to_tensors(batch, "cpu"))
        for key in ("loss", "lr", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= 1e-5 * abs(
                float(jm[key])), (i, key, float(m[key]), float(jm[key]))
        lr_sum += float(jm["lr"])
        if tiny is None:    # |g| of the first step, from its moment
            tiny = [np.sqrt(np.asarray(nu)) < 1e-5 * np.sqrt(
                np.asarray(nu)).max()
                for nu in jax.tree_util.tree_leaves(j_state.opt.nu)]
        flat = jax.tree_util.tree_flatten_with_path(j_state.params)[0]
        for (path, want), small in zip(flat, tiny):
            err = np.abs(_leaf(state.params, path).numpy() - np.asarray(want))
            assert err[~small].max(initial=0) < 1e-6 + 0.01 * lr_sum, (
                i, path)
            assert err.max() < 1e-6 + 2 * lr_sum, (i, path)


@pytest.mark.parametrize("arch", ["qwen2-7b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
def test_synthetic_batches_bitwise_the_reference(arch):
    """Dense, vlm and audio layouts: batch i is the reference's batch i,
    bit for bit, and ``start`` seeks to it."""
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    ours, ref = synthetic_batches(cfg, 3, 32, seed=4), j_batches(jcfg, 3,
                                                                  32, 4)
    got = [next(ours) for _ in range(3)]
    for b in got:
        want = next(ref)
        assert sorted(b) == sorted(want)
        for k in b:
            assert b[k].dtype == want[k].dtype
            np.testing.assert_array_equal(b[k], want[k])
    seeked = next(synthetic_batches(cfg, 3, 32, seed=4, start=2))
    for k in seeked:
        np.testing.assert_array_equal(seeked[k], got[2][k])


def test_int8_error_feedback_matches_the_reference():
    """Four rounds of compress on a tree of ragged leaves: the dequantised
    gradients and the residuals equal the reference's."""
    rng = np.random.default_rng(8)
    shapes = {"a": (70,), "b": (3, 33), "c": {"d": (5, 4, 3)}}

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(np.float32)
                for k, v in tree.items()}
    comp, jcomp = Int8ErrorFeedback(block=32), JInt8EF(block=32)
    first = draw(shapes)
    carry = comp.init(jax.tree.map(torch.from_numpy, first))
    jcarry = jcomp.init(jax.tree.map(jnp.asarray, first))
    assert comp.wire_volume_ratio() == jcomp.wire_volume_ratio()
    for _ in range(4):
        g = draw(shapes)
        sent, carry = comp.compress(jax.tree.map(torch.from_numpy, g),
                                    carry)
        jsent, jcarry = jcomp.compress(jax.tree.map(jnp.asarray, g), jcarry)
        for a, b in zip(tree_leaves(sent), jax.tree_util.tree_leaves(jsent)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for a, b in zip(tree_leaves(carry.residual),
                        jax.tree_util.tree_leaves(jcarry.residual)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 100))
def test_int8_error_feedback_unbiased_over_time(seed):
    """The port of ``tests/test_properties.py``'s property: the sum of the
    compressed gradients tracks the sum of the true ones to within one
    quantisation step."""
    rng = np.random.default_rng(seed)
    comp = Int8ErrorFeedback(block=32)
    carry = comp.init(torch.zeros(64))
    total_true, total_sent = np.zeros(64), np.zeros(64)
    for _ in range(20):
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        sent, carry = comp.compress(g, carry)
        total_true += g.numpy()
        total_sent += sent.numpy()
    resid = np.abs(total_true - total_sent).max()
    assert resid < 0.2, f"error-feedback residual {resid}"


def test_save_collectives_remat_raises():
    """Only an unknown remat policy raises.  ``"save_collectives"`` (the
    reference's policy: keep each block's two outputs, recompute the rest;
    under a mesh also the collectives' outputs, see
    ``tests/test_torch_mesh_train.py``) gives remat=True's loss and
    gradients on one device."""
    cfg = configs.get_smoke("qwen2-7b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), tp=1,
                            device="cpu")
    tokens = torch.arange(8, dtype=torch.int32).reshape(1, 8) % cfg.vocab
    with pytest.raises(ValueError, match="remat"):
        tfm.forward(cfg, params, tokens, remat="save_everything")
    batch = {"tokens": tokens, "targets": tokens,
             "mask": torch.ones((1, 8))}
    leaves = tree_leaves(params)
    out = {}
    for remat in (True, "save_collectives"):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss = lm.make_loss_fn(cfg, remat=remat, xent_chunk=XENT_CHUNK)(
            tree_unflatten(params, ps), batch)
        out[remat] = (loss, torch.autograd.grad(loss, ps))
    assert torch.equal(out[True][0], out["save_collectives"][0])
    for a, b in zip(out["save_collectives"][1], out[True][1]):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_specs_are_the_references():
    """input_specs, cache_specs and abstract_params: the reference's
    shapes (and dtypes) on the meta device, no allocation."""
    for arch in ("qwen2-7b", "pixtral-12b", "seamless-m4t-large-v2"):
        cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
        for name in ("train_4k", "decode_32k"):
            got = lm.input_specs(cfg, lm.SHAPES[name])
            want = jlm.input_specs(jcfg, jlm.SHAPES[name])
            assert sorted(got) == sorted(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
        shape = lm.ShapeSpec("small", 64, 2, "decode")
        got = tree_leaves(lm.cache_specs(cfg, shape))
        want = jax.tree_util.tree_leaves(jlm.cache_specs(jcfg, shape))
        assert sorted(tuple(t.shape) for t in got) == sorted(
            tuple(w.shape) for w in want)
        got = tree_leaves(lm.abstract_params(cfg, tp=2))
        want = jax.tree_util.tree_leaves(jlm.abstract_params(jcfg, tp=2))
        assert [tuple(t.shape) for t in got] == [w.shape for w in want]
        assert all(t.device.type == "meta" for t in got)


def _args(tmp, **kw):
    base = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "16", "--steps", "4", "--lr", "1e-2",
            "--ckpt-every", "2", "--log-every", "1", "--ckpt-dir", str(tmp)]
    for k, v in kw.items():
        base += [f"--{k}", str(v)]
    return train_launch.parse_args(base)


def test_train_launcher_resumes_bitwise(tmp_path):
    """``launch/train.py``'s LM half: 4 steps with checkpoints at steps 1
    and 3; with step 3's removed, a relaunch resumes at step 2 (the data
    stream seeked) and ends bitwise where the uninterrupted run did."""
    import shutil
    run = train_launch.train_lm(_args(tmp_path / "a"))
    assert [r["step"] for r in run["rows"]] == [0, 1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["tokens_per_s"] > 0
               for r in run["rows"])
    steps = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert steps == ["step_000000001", "step_000000003"]
    shutil.rmtree(tmp_path / "a" / "step_000000003")
    again = train_launch.train_lm(_args(tmp_path / "a"))
    assert again["start"] == 2 and [r["step"] for r in again["rows"]] == [
        2, 3]
    for a, b in zip(run["rows"][2:], again["rows"]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    for a, b in zip(tree_leaves(run["state"].params),
                    tree_leaves(again["state"].params)):
        assert torch.equal(a, b)
    assert again["state"].step == 4 and again["state"].opt.count == 4


def test_train_lm_launcher_scales_the_family(monkeypatch):
    """``launch/train_lm.py``: the smoke config at ~100M parameters, its
    family kept (GQA + bias, MoE routing, the window), trained a step."""
    cfg = train_lm_launch.hundred_m_config("qwen2-7b")
    assert (cfg.d_model, cfg.n_layers, cfg.vocab, cfg.n_heads,
            cfg.kv_heads, cfg.hd, cfg.qkv_bias) == (512, 8, 32000, 8, 2,
                                                    64, True)
    moe = train_lm_launch.hundred_m_config("moonshot-v1-16b-a3b")
    assert moe.moe is not None and moe.d_model == 512
    swa = train_lm_launch.hundred_m_config("h2o-danube-3-4b")
    assert swa.sliding_window > 0
    # one step at a small width, through the launcher's own path
    monkeypatch.setattr(train_lm_launch, "SCALE", dict(
        d_model=64, n_layers=2, d_ff=128, vocab=512))
    out = train_lm_launch.main(["--arch", "starcoder2-3b", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--device",
                                "cpu"])
    assert out["cfg"].d_model == 64 and len(out["rows"]) == 2
    assert all(np.isfinite(r["loss"]) for r in out["rows"])


def test_hundred_m_config_is_about_a_hundred_million():
    cfg = dataclasses.replace(train_lm_launch.hundred_m_config("qwen2-7b"))
    n = sum(t.numel() for t in tree_leaves(lm.abstract_params(cfg, tp=1)))
    assert 40e6 < n < 150e6


@pytest.mark.parametrize("arch,layers", [
    ("qwen2-7b", 12), ("deepseek-v3-671b", 3), ("seamless-m4t-large-v2", 24)])
def test_train_depth_sizes_the_model_train_lm_builds(arch, layers):
    """``launch/train.py:train_depth`` at the card's 60 GiB: the training
    state of the model ``train_lm`` builds (tp = 1, 16 bytes a parameter,
    from the meta device), the most layers that fit; an MoE arch cut to
    its dense layers, an encoder-decoder's encoder cut alike."""
    from repro_torch.utils.tree import tree_count
    full = configs.get(arch)
    cut, gib = train_launch.train_depth(full, 60.0)
    assert cut.n_layers == layers

    def state_bytes(c):
        return tree_count(lm.abstract_params(c, tp=1)) * 16
    assert gib == state_bytes(cut) / 2 ** 30 <= 60.0
    if layers < full.n_layers:
        more = train_launch.depth_cut(full, layers + 1)
        assert state_bytes(more) / 2 ** 30 > 60.0
    if full.moe is not None:
        assert cut.moe.first_dense == layers <= full.moe.first_dense
    if full.family == "audio":
        assert cut.encoder_layers == layers
    with pytest.raises(ValueError, match="not 1 layers fit"):
        train_launch.fit_depth(full, 1e-3, state_bytes)


def test_checkpoint_round_trips_bf16_leaves(tmp_path):
    """A bf16 train state (the card's) is stored as its int16 bits and
    loads back bitwise as bf16."""
    from repro_torch.ckpt.checkpoint import load_checkpoint, save_checkpoint
    cfg = dataclasses.replace(configs.get_smoke("qwen2-7b"),
                              dtype="bfloat16")
    state = init_train_state(lm.init_params(
        cfg, torch.Generator().manual_seed(2), tp=1, device="cpu"))
    assert tree_leaves(state.params)[0].dtype == torch.bfloat16
    save_checkpoint(str(tmp_path), 5, state)
    like = init_train_state(lm.init_params(
        cfg, torch.Generator().manual_seed(3), tp=1, device="cpu"))
    got, step = load_checkpoint(str(tmp_path), like)
    assert step == 5
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("s,t,causal,window", [
    (40, 40, True, 0), (48, 80, True, 16), (24, 56, False, 0),
    (100, 60, True, 7), (30, 30, False, 5)])
def test_roofline_counts_the_kept_pairs(s, t, causal, window):
    """``launch/roofline.py``: the pairs the masks keep, counted against
    the mask itself, and the backward's bytes and flops from them."""
    from repro_torch.launch import roofline
    qp, kp = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    assert roofline.fa_pairs(s, t, causal, window) == int(ok.sum())
    b, h, hkv, d, dv = 2, 4, 2, 32, 16
    q, k, v = (torch.zeros(sh) for sh in ((b, s, h, d), (b, t, hkv, d),
                                          (b, t, hkv, dv)))
    o, do = torch.zeros((b, s, h, dv)), torch.zeros((b, s, h, dv))
    lse = torch.zeros((b, h, s))
    nb, flops = roofline.fa_bwd_work(q, k, v, o, lse, do, causal=causal,
                                     window=window)
    assert flops == 2.0 * b * h * int(ok.sum()) * (3 * d + 2 * dv)
    assert nb == 4 * (2 * (q.numel() + k.numel() + v.numel())
                      + o.numel() + do.numel() + lse.numel())
