"""The port's LM serving path (``ssm`` and ``hybrid`` families) against the
JAX package.

On the smoke configs of ``mamba2-2.7b`` and ``zamba2-2.7b`` both packages
run the same weights (``params_from_jax`` of the reference's
``init_params(PRNGKey(0), tp=2)``) and the same tokens at f32: forward
logits and 16 decode steps agree within 2e-5 of max |logit|.  The port's
own decode holds against its forward within 5e-3, the bar of
``tests/test_decode_consistency.py``.  The reference's forward runs its plain
``ssd_chunked`` and ``chunked_attention``; the port's runs the kernel
wrappers, which on CPU tensors call their plain versions.  The full configs
of every arch of the registry are built on the meta device and their
shapes held against ``jax.eval_shape`` of the reference's
``init_params(tp=16)``.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import attention as tattn
from repro_torch.models import lm
from repro_torch.models import transformer as tfm

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
B, S, STEPS = 2, 32, 16


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """Both packages' logits for one arch: forward and STEPS decode steps."""
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=2)
    params = lm.params_from_jax(cfg, _tree(jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)

    @jax.jit
    def j_forward(p, t):
        h, _, logits_fn = jtfm.forward(jcfg, p, t, remat=False, kv_chunk=8)
        return logits_fn(h)
    j_decode = jax.jit(partial(jtfm.decode_step, jcfg))
    j_full = np.asarray(j_forward(jparams, jnp.asarray(tokens)))
    caches = jtfm.init_caches(jcfg, B, S, jnp.float32)
    j_steps = []
    for i in range(STEPS):
        logits, caches = j_decode(jparams, caches,
                                  jnp.asarray(tokens[:, i:i + 1]),
                                  jnp.full((B,), i, jnp.int32))
        j_steps.append(np.asarray(logits))

    t_tokens = torch.from_numpy(tokens)
    h, _, logits_fn = tfm.forward(cfg, params, t_tokens)
    t_full = logits_fn(h).numpy()
    decode = lm.make_decode_fn(cfg)
    t_caches = tfm.init_caches(cfg, B, S, torch.float32, device="cpu")
    t_steps = []
    for i in range(STEPS):
        logits, t_caches = decode(params, t_caches, {
            "token": t_tokens[:, i:i + 1],
            "position": torch.full((B,), i, dtype=torch.int32)})
        t_steps.append(logits.numpy())
    return dict(arch=arch, cfg=cfg, params=params, tokens=t_tokens,
                j_full=j_full, j_steps=np.stack(j_steps, 1), t_full=t_full,
                t_steps=np.stack(t_steps, 1))


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_forward_matches_jax(case):
    assert case["t_full"].shape == case["j_full"].shape
    assert _rel(case["t_full"], case["j_full"]) < 2e-5


def test_decode_matches_jax(case):
    assert _rel(case["t_steps"], case["j_steps"]) < 2e-5


def test_decode_matches_forward(case):
    assert _rel(case["t_steps"], case["t_full"][:, :STEPS]) < 5e-3


def test_prefill_fn_returns_last_position_logits(case):
    got = lm.make_prefill_fn(case["cfg"])(case["params"],
                                          {"tokens": case["tokens"]})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), case["t_full"][:, -1], rtol=0,
                               atol=1e-6)


def test_forward_calls_each_kernel_wrapper(case, monkeypatch):
    """SSD once per Mamba-2 block, FA once per shared-block invocation."""
    calls = {"ssd": 0, "fa": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(ssd_ops, "ssd_chunk_step",
                        counting("ssd", ssd_ops.ssd_chunk_step))
    monkeypatch.setattr(tattn, "flash_attention",
                        counting("fa", tattn.flash_attention))
    cfg = case["cfg"]
    tfm.forward(cfg, case["params"], case["tokens"])
    shared = cfg.n_layers // cfg.shared_every if cfg.shared_every else 0
    assert calls == {"ssd": cfg.n_layers, "fa": shared}


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = (tuple(v.shape), str(v.dtype).replace(
                "torch.", ""))
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_full_config_shapes_match_jax(arch):
    cfg = configs.get(arch)
    want = jax.eval_shape(lambda: jlm.init_params(
        jconfigs.get(arch), jax.random.PRNGKey(0), tp=16))
    got = lm.init_params(cfg, None, device="meta")
    assert _shapes(got) == _shapes(want)
    n = sum(int(np.prod(s)) for s, _ in _shapes(got).values())
    if arch == "zamba2-2.7b":
        assert 2.3e9 < n < 2.5e9


def test_params_from_jax_keeps_leaf_dtypes():
    jcfg = dataclasses.replace(jconfigs.get_smoke("zamba2-2.7b"),
                               dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke("zamba2-2.7b"),
                              dtype="bfloat16")
    tree = _tree(jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=2))
    params = lm.params_from_jax(cfg, tree, device="cpu")
    ssm = params["g0"]["ssm"]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert ssm[k].dtype == torch.float32
    assert ssm["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        ssm["in_proj"].float().numpy(),
        np.asarray(tree["g0"]["ssm"]["in_proj"], np.float32))
    del tree["shared"]["mlp"]
    with pytest.raises(KeyError, match="missing"):
        lm.params_from_jax(cfg, tree, device="cpu")


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("zamba2-2.7b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_caches(cfg, 1, 8)
    tree = _tree(jlm.init_params(jconfigs.get_smoke("zamba2-2.7b"),
                                 jax.random.PRNGKey(0), tp=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.params_from_jax(cfg, tree)


def test_unported_archs_raise():
    """What raises: an arch outside the registry and an unknown MoE
    dispatch.  The expert-parallel dispatch is a mesh's; with no mesh
    ``moe_impl="ep"`` takes the dense dispatch, as in the reference."""
    with pytest.raises(KeyError, match="unknown"):
        configs.get("no-such-arch")
    auto = configs.get_smoke("moonshot-v1-16b-a3b")
    params = lm.init_params(auto, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {"tokens": torch.arange(4, dtype=torch.long)[None]}
    want = lm.make_prefill_fn(auto)(params, batch)
    ep = dataclasses.replace(auto, moe_impl="ep")
    assert torch.equal(lm.make_prefill_fn(ep)(params, batch), want)
    bad = dataclasses.replace(auto, moe_impl="megablocks")
    with pytest.raises(ValueError, match="moe_impl"):
        lm.make_prefill_fn(bad)(params, batch)


def test_init_params_draws_from_the_generator():
    cfg = configs.get_smoke("mamba2-2.7b")
    a = lm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = lm.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = lm.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["g0"]["ssm"]["in_proj"], b["g0"]["ssm"]["in_proj"])
    assert not torch.equal(a["g0"]["ssm"]["in_proj"],
                           c["g0"]["ssm"]["in_proj"])
    assert a["g0"]["ssm"]["in_proj"].dtype == torch.float32
