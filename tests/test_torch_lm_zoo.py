"""The rest of the LM zoo's serving path in the port (the dense, MoE, MLA,
vlm and encoder-decoder families) against the JAX package.

On the smoke config of each of the eight archs both packages run the same
weights (``params_from_jax`` of the reference's ``init_params(PRNGKey(0),
tp=2)``) and the same inputs at f32: forward logits and a decode step for
each token agree within 2e-5 of max |logit|, the bar of
``tests/test_torch_lm.py``.
The port's own decode holds against its forward within 5e-3, the bar of
``tests/test_decode_consistency.py`` (whose MoE configs take a capacity
factor of 8, so the prefill drops no token).  The reference's forward runs
its plain ``chunked_attention``; the port's runs the flash wrapper
(``flash_attention``), which on CPU tensors calls
``flash_attention_plain``: once per layer for the
decoder-only families, enc + 2 * dec times for the encoder-decoder.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import encdec as jenc
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import configs
from repro_torch.kernels.attention import kernel as tkern
from repro_torch.models import attention as tattn
from repro_torch.models import common
from repro_torch.models import encdec
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from torch_one_thread import one_torch_thread  # noqa: F401

ARCHS = ["h2o-danube-3-4b", "qwen2-7b", "minitron-4b", "starcoder2-3b",
         "pixtral-12b", "deepseek-v3-671b", "moonshot-v1-16b-a3b",
         "seamless-m4t-large-v2"]
B, S, SRC = 2, 16, 24        # decoder tokens, encoder frames (audio)
SWA_S = 40   # a sliding-window arch's tokens: 2.5 windows of its smoke 16,
             # so the forward masks keys and the decode ring wraps twice


def _tree(params):
    return jax.tree.map(np.asarray, params)


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _no_drop(cfg):
    """The reference's decode-consistency setting: no prefill drops."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def _seq(cfg):
    return SWA_S if cfg.sliding_window else S


def _inputs(cfg):
    rng = np.random.default_rng(1)
    out = {"tokens": rng.integers(0, cfg.vocab,
                                  (B, _seq(cfg))).astype(np.int32)}
    if cfg.family == "vlm":
        s_img, _ = lm._frontend_split(cfg, _seq(cfg))
        out["embeds"] = rng.standard_normal(
            (B, s_img, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["src_embeds"] = rng.standard_normal(
            (B, SRC, cfg.d_model)).astype(np.float32)
    return out


def _jax_run(jcfg, jparams, inp):
    """The reference's all-position forward logits and a decode step for
    each token."""
    tokens = jnp.asarray(inp["tokens"])
    s = tokens.shape[1]
    if jcfg.family == "audio":
        src = jnp.asarray(inp["src_embeds"])

        @jax.jit
        def fwd(p):
            h, _, logits_fn = jenc.forward(jcfg, p, tokens, src, remat=False,
                                           kv_chunk=8)
            return logits_fn(h)
        enc_out = jenc.encode(jcfg, jparams, src, remat=False, kv_chunk=8)
        caches = jenc.init_caches(jcfg, B, s, SRC, jnp.float32)
        kv = [jenc._enc_kv(jcfg, jax.tree.map(lambda x: x[i], jparams["dec"]),
                           enc_out, None) for i in range(jcfg.n_layers)]
        caches = {**caches, "cross_k": jnp.stack([k for k, _ in kv]),
                  "cross_v": jnp.stack([v for _, v in kv])}
        step = jax.jit(partial(jenc.decode_step, jcfg))
    else:
        embeds = (jnp.asarray(inp["embeds"]) if "embeds" in inp else None)

        @jax.jit
        def fwd(p):
            h, _, logits_fn = jtfm.forward(jcfg, p, tokens, embeds,
                                           remat=False, kv_chunk=8)
            return logits_fn(h)
        caches = jtfm.init_caches(jcfg, B, s, jnp.float32)
        step = jax.jit(partial(jtfm.decode_step, jcfg))
    full = np.asarray(fwd(jparams))
    steps = []
    for i in range(s):
        logits, caches = step(jparams, caches, tokens[:, i:i + 1],
                              jnp.full((B,), i, jnp.int32))
        steps.append(np.asarray(logits))
    return full, np.stack(steps, 1)


def _torch_forward(cfg, params, inp):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    if cfg.family == "audio":
        h, _, logits_fn = encdec.forward(cfg, params, t["tokens"],
                                         t["src_embeds"])
    else:
        h, _, logits_fn = tfm.forward(cfg, params, t["tokens"],
                                      t.get("embeds"))
    return logits_fn(h).numpy()


def _torch_steps(cfg, params, inp):
    tokens = torch.from_numpy(inp["tokens"])
    s = tokens.shape[1]
    if cfg.family == "audio":
        caches = encdec.init_caches(cfg, B, s, SRC, torch.float32,
                                    device="cpu")
        encdec.fill_cross_kv(cfg, params, caches,
                             torch.from_numpy(inp["src_embeds"]))
    else:
        caches = tfm.init_caches(cfg, B, s, torch.float32, device="cpu")
    decode = lm.make_decode_fn(cfg)
    out = []
    for i in range(s):
        logits, caches = decode(params, caches, {
            "token": tokens[:, i:i + 1],
            "position": torch.full((B,), i, dtype=torch.int32)})
        out.append(logits.numpy())
    return np.stack(out, 1)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """Both packages' logits for one arch: forward and a decode step for
    each token (``SWA_S`` of them for a sliding-window arch, else ``S``)."""
    arch = request.param
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    # a window binds in the forward and its decode ring wraps
    assert not cfg.sliding_window or _seq(cfg) > 2 * cfg.sliding_window
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=2)
    params = lm.params_from_jax(cfg, _tree(jparams), device="cpu")
    inp = _inputs(cfg)
    j_full, j_steps = _jax_run(jcfg, jparams, inp)
    return dict(arch=arch, cfg=cfg, params=params, inp=inp, j_full=j_full,
                j_steps=j_steps, t_full=_torch_forward(cfg, params, inp),
                t_steps=_torch_steps(cfg, params, inp))


def test_forward_matches_jax(case):
    assert case["t_full"].shape == case["j_full"].shape
    assert _rel(case["t_full"], case["j_full"]) < 2e-5


def test_decode_matches_jax(case):
    assert _rel(case["t_steps"], case["j_steps"]) < 2e-5


def test_decode_matches_forward(case):
    cfg = _no_drop(case["cfg"])
    full = _torch_forward(cfg, case["params"], case["inp"])
    steps = (case["t_steps"] if cfg is case["cfg"] else
             _torch_steps(cfg, case["params"], case["inp"]))
    # vlm: the decode steps see only the tokens, so the forward runs them
    # alone (the embeds' path is test_forward_matches_jax's)
    if "embeds" in case["inp"]:
        inp = {"tokens": case["inp"]["tokens"]}
        full = _torch_forward(cfg, case["params"], inp)
    assert _rel(steps, full) < 5e-3


def test_prefill_fn_returns_last_position_logits(case):
    batch = {k: torch.from_numpy(v) for k, v in case["inp"].items()}
    got = lm.make_prefill_fn(case["cfg"])(case["params"], batch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), case["t_full"][:, -1], rtol=0,
                               atol=1e-6)


def test_forward_calls_flash_once_per_attention(case, monkeypatch):
    """n_layers for the decoder-only families; for the encoder-decoder
    one call per encoder layer and two (self, cross) per decoder layer."""
    calls = []
    real = tkern.flash_attention

    def counting(*args, **kwargs):
        calls.append(kwargs.get("causal", True))
        return real(*args, **kwargs)
    monkeypatch.setattr(tattn, "flash_attention", counting)
    monkeypatch.setattr(encdec, "flash_attention", counting)
    cfg = case["cfg"]
    _torch_forward(cfg, case["params"], case["inp"])
    if cfg.family == "audio":
        n = cfg.encoder_layers + 2 * cfg.n_layers
        assert calls.count(False) == cfg.encoder_layers + cfg.n_layers
    else:
        n = cfg.n_layers
        assert all(calls)
    assert len(calls) == n


# ---------------------------------------------------------------------------
# MoE: capacity drops and the softmax router
# ---------------------------------------------------------------------------

def _ref_keep(jcfg, idx, t):
    """The reference dispatch's kept (token, choice) pairs, its own lines."""
    m = jcfg.moe
    cap = max(int(t * m.top_k / m.n_experts * m.capacity_factor), 4)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(t * m.top_k, m.n_experts)
    pos_in_e = jnp.cumsum(flat, axis=0) - flat
    slot = jnp.sum(pos_in_e * flat, axis=-1)
    return np.asarray(slot < cap), np.asarray(slot)


@pytest.mark.parametrize("router", ["sigmoid", "softmax"])
def test_moe_drops_the_reference_pairs(router):
    """A capacity of 4 slots for 64 (token, choice) pairs on 8 experts:
    the port keeps and drops the reference's pairs, and its output and aux
    loss equal the reference's."""
    def small(c):
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=0.5, router=router))
    jcfg = small(jconfigs.get_smoke("moonshot-v1-16b-a3b"))
    cfg = small(configs.get_smoke("moonshot-v1-16b-a3b"))
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    t = B * S
    j_y, j_aux = jmoe.apply_moe_dense(jcfg, jp, jnp.asarray(x))
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    _, j_idx, _ = jmoe._route(jcfg, jp, jnp.asarray(x.reshape(t, -1)))
    _, idx, _ = moe._route(cfg, p, torch.from_numpy(x.reshape(t, -1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    want_keep, want_slot = _ref_keep(jcfg, j_idx, t)
    _, slot, keep, cap = moe.dispatch(cfg, idx, t)
    assert cap == 4 and 0 < int(keep.sum()) < t * cfg.moe.top_k
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    assert _rel(y.numpy(), np.asarray(j_y)) < 2e-5
    assert abs(float(aux) - float(j_aux)) <= 1e-6 * max(abs(float(j_aux)), 1)
    if router == "sigmoid":
        assert float(aux) == 0.0


def test_moe_ep_and_unknown_arch_raise():
    """With no mesh ``moe_impl="ep"`` is the dense dispatch (the reference
    takes its expert-parallel path only under a mesh); an unknown
    dispatch and an unknown arch raise."""
    cfg = configs.get_smoke("moonshot-v1-16b-a3b")
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 4, cfg.d_model), generator=g)
    p = moe.init_moe(cfg, g, torch.float32, torch.device("cpu"))
    want, want_aux = moe.apply_moe_dense(cfg, p, x)
    y, aux = moe.apply_moe(dataclasses.replace(cfg, moe_impl="ep"), p, x)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.apply_moe(dataclasses.replace(cfg, moe_impl="megablocks"), p, x)
    with pytest.raises(KeyError, match="unknown"):
        configs.get("no-such-arch")


# ---------------------------------------------------------------------------
# the flash kernel's plain version at the new widths
# ---------------------------------------------------------------------------

FA_CASES = {   # b, s, t, h, hkv, d, dv, causal, window
    "d120_window": (1, 40, 40, 4, 2, 120, 120, True, 16),
    "d192_dv128": (1, 32, 32, 4, 4, 192, 128, True, 0),
    "noncausal_s_ne_t": (2, 24, 56, 4, 4, 64, 64, False, 0),
}


@pytest.mark.parametrize("name", list(FA_CASES))
def test_flash_plain_matches_chunked_attention(name):
    b, s, t, h, hkv, d, dv, causal, win = FA_CASES[name]
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, dv)))
    q_pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    k_pos = (jnp.broadcast_to(jnp.arange(t), (b, t)) if causal else
             jnp.zeros((b, t), jnp.int32))
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_pos, k_pos,
        window=win, kv_chunk=16))
    got = tkern.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=win).numpy()
    assert got.shape == (b, s, h, dv)
    assert _rel(got, want) < 2e-5
    assert tkern.fa_body(torch.bfloat16, d, dv) == (
        "tc_k12" if d > 128 else "tc_k8")


def test_cross_kv_are_the_encoders():
    """fill_cross_kv writes each decoder layer's K/V of the encoder output
    (the reference builds them by hand in its decode test)."""
    jcfg = jconfigs.get_smoke("seamless-m4t-large-v2")
    cfg = configs.get_smoke("seamless-m4t-large-v2")
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0), tp=2)
    params = lm.params_from_jax(cfg, _tree(jparams), device="cpu")
    src = np.random.default_rng(5).standard_normal(
        (B, SRC, cfg.d_model)).astype(np.float32)
    enc_out = jenc.encode(jcfg, jparams, jnp.asarray(src), remat=False,
                          kv_chunk=8)
    caches = encdec.fill_cross_kv(
        cfg, params, encdec.init_caches(cfg, B, S, SRC, torch.float32,
                                        device="cpu"), torch.from_numpy(src))
    for i in range(cfg.n_layers):
        k, v = jenc._enc_kv(jcfg, jax.tree.map(lambda x: x[i],
                                               jparams["dec"]), enc_out, None)
        assert _rel(caches["cross_k"][i].numpy(), np.asarray(k)) < 2e-5
        assert _rel(caches["cross_v"][i].numpy(), np.asarray(v)) < 2e-5


@pytest.mark.parametrize("shape,draws", [((10, 3, 8), 5), ((3, 40, 8), 15)])
def test_normal_draws_a_large_cast_leaf_in_blocks(monkeypatch, shape, draws):
    """A bf16 leaf above DRAW_CHUNK values is drawn in blocks of leading
    rows of at most DRAW_CHUNK values (one index at a time, itself in
    blocks, where one index holds more), not a row per draw."""
    monkeypatch.setattr(common, "DRAW_CHUNK", 64)
    sizes = []
    real = torch.randn

    def counting(size, *args, **kwargs):
        sizes.append(int(np.prod(size)))
        return real(size, *args, **kwargs)
    monkeypatch.setattr(torch, "randn", counting)
    x = common.normal(torch.Generator().manual_seed(0), shape, 0.5,
                      torch.bfloat16, torch.device("cpu"))
    assert x.shape == shape and x.dtype == torch.bfloat16
    assert len(sizes) == draws and max(sizes) <= 64
    assert sum(sizes) == x.numel()
    assert len(torch.unique(x.float())) > x.numel() // 4
