"""The port's optimizers (``repro_torch.train.optimizer``) against the JAX
package's.

One f64 JAX subprocess (x64) per module runs the reference's AdamW for five
steps on fixed parameters and two gradient sequences (a NEPSpinParams-shaped
tree; global norms ~3, under the clip of 10, and ~34, where the clip binds
every step), and one SNES generation: ``snes_ask``'s noise and population
and ``snes_tell`` on fixed fitnesses.  The port takes the same numbers at
f64.  Then the port's own analogues of ``tests/test_train.py``'s optimizer
tests.

AdamW does its math in f32 whatever the parameters' dtype (the
reference's rule).  Every f32 operation of the update is an IEEE-rounded
elementwise one and agrees bitwise, except the global norm's f32 sum of
squares, whose summation order differs between XLA and torch (neither is
specified; they differ by a few f32 ulps on about half of all vectors).
While the clip does not bind its scale is exactly 1 and the steps agree
within 1e-12; where it binds, the scale carries that rounding difference
(~6e-8 relative): the parameters and the f32 moments agree within 1e-6
(measured: 6.4e-9 and 1.4e-7, one and two f32 ulps of the moments).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.train.optimizer import (adamw_init, adamw_update,
                                         cosine_schedule, snes_ask,
                                         snes_init, snes_member, snes_tell)
from torch_one_thread import XLA_ONE_THREAD, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
F64 = torch.float64
SHAPES = [(2, 2, 4, 6), (2, 12), (2,), (5,)]
STEPS = 5
GRAD_SCALE = {"clip_free": 0.3, "clip_binding": 3.0}
POP = 6

_JAX_SCRIPT = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from repro.train.optimizer import (adamw_init, adamw_update, snes_ask,
                                   snes_init, snes_tell)

d = np.load(sys.argv[1])
steps, pop = int(d["steps"]), int(d["pop"])
n = int(d["n_leaves"])
params = [jnp.asarray(d[f"p{i}"]) for i in range(n)]
out = {}
for case in ("clip_free", "clip_binding"):
    opt = adamw_init(params)
    p = params
    for s in range(steps):
        grads = [jnp.asarray(d[f"{case}_g{s}_{i}"]) for i in range(n)]
        p, opt = adamw_update(p, grads, opt, 0.01, weight_decay=0.05,
                              grad_clip=float(d["clip"]))
        for i in range(n):
            out[f"{case}_adam{s}_{i}"] = np.asarray(p[i])
    for i in range(n):
        out[f"{case}_mu_{i}"] = np.asarray(opt.mu[i])
        out[f"{case}_nu_{i}"] = np.asarray(opt.nu[i])
state = snes_init(params, 0.05)
pop_tree, noise = snes_ask(state, jax.random.PRNGKey(3), pop)
new = snes_tell(state, noise, jnp.asarray(d["fitness"]))
for i in range(n):
    out[f"noise_{i}"] = np.asarray(noise[i])
    out[f"pop_{i}"] = np.asarray(pop_tree[i])
    out[f"mean_{i}"] = np.asarray(new.mean[i])
    out[f"sigma_{i}"] = np.asarray(new.sigma[i])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("optimizer")
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s) for s in SHAPES]
    grads = {case: [[scale * rng.standard_normal(sh) for sh in SHAPES]
                    for _ in range(STEPS)]
             for case, scale in GRAD_SCALE.items()}
    fitness = rng.standard_normal(POP)
    np.savez(d / "in.npz", steps=STEPS, pop=POP, n_leaves=len(SHAPES),
             clip=10.0, fitness=fitness,
             **{f"p{i}": p for i, p in enumerate(params)},
             **{f"{case}_g{s}_{i}": g for case, seq in grads.items()
                for s, gs in enumerate(seq) for i, g in enumerate(gs)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_ONE_THREAD)
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "in.npz"),
                        str(d / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(ref=np.load(d / "out.npz"), params=params, grads=grads,
                fitness=fitness)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-300))


@pytest.mark.parametrize("case, bar", [("clip_free", 1e-12),
                                       ("clip_binding", 1e-6)])
def test_adamw_update_matches_reference_f64(reference, case, bar):
    """Five AdamW steps (f32 math, f32 moments, bias correction, global-norm
    clip 10) from f64 parameters: every step's parameters and the final
    moments against the reference's (the bars: module docstring)."""
    ref = reference["ref"]
    params = [torch.tensor(p, dtype=F64) for p in reference["params"]]
    opt = adamw_init(params)
    for s in range(STEPS):
        grads = [torch.tensor(g, dtype=F64)
                 for g in reference["grads"][case][s]]
        params, opt = adamw_update(params, grads, opt, 0.01,
                                   weight_decay=0.05, grad_clip=10.0)
        for i, p in enumerate(params):
            assert p.dtype == F64
            assert _rel(p.numpy(), ref[f"{case}_adam{s}_{i}"]) < bar, (s, i)
    assert opt.count == STEPS
    for i in range(len(SHAPES)):
        assert opt.mu[i].dtype == torch.float32
        assert _rel(opt.mu[i].numpy(), ref[f"{case}_mu_{i}"]) < bar
        assert _rel(opt.nu[i].numpy(), ref[f"{case}_nu_{i}"]) < bar


def test_snes_ask_tell_match_reference_f64(reference):
    """SNES fed the reference's half draws: the mirrored population, and
    ``snes_tell``'s rank-utility mean and sigma updates within 1e-12."""
    ref = reference["ref"]
    params = [torch.tensor(p, dtype=F64) for p in reference["params"]]
    state = snes_init(params, 0.05)
    half = [torch.tensor(ref[f"noise_{i}"][:POP // 2])
            for i in range(len(SHAPES))]
    pop, z = snes_ask(state, None, POP, noise=half)
    for i in range(len(SHAPES)):
        assert _rel(z[i].numpy(), ref[f"noise_{i}"]) < 1e-12
        assert _rel(pop[i].numpy(), ref[f"pop_{i}"]) < 1e-12
    new = snes_tell(state, z, torch.tensor(reference["fitness"], dtype=F64))
    assert new.count == 1
    for i in range(len(SHAPES)):
        assert _rel(new.mean[i].numpy(), ref[f"mean_{i}"]) < 1e-12
        assert _rel(new.sigma[i].numpy(), ref[f"sigma_{i}"]) < 1e-12


def test_adamw_reduces_quadratic():
    w = [torch.tensor([5.0, -3.0, 2.0])]
    opt = adamw_init(w)
    for _ in range(300):
        w, opt = adamw_update(w, [2 * w[0]], opt, 0.05, weight_decay=0.0)
    assert float(w[0].abs().max()) < 0.2


def test_snes_minimizes_sphere():
    w = [torch.tensor(np.random.default_rng(0).normal(size=(8,)) * 2,
                      dtype=torch.float32)]
    state = snes_init(w, sigma0=0.3)
    g = torch.Generator().manual_seed(0)
    for _ in range(150):
        pop, z = snes_ask(state, g, 16)
        fit = torch.stack([torch.sum(snes_member(pop, i, w)[0] ** 2)
                           for i in range(16)])
        state = snes_tell(state, z, fit)
    assert float(torch.sum(state.mean[0] ** 2)) < 0.1


def test_cosine_schedule_shape():
    lr0 = cosine_schedule(0, peak_lr=1e-3, warmup=10, total=100)
    lrp = cosine_schedule(10, peak_lr=1e-3, warmup=10, total=100)
    lre = cosine_schedule(99, peak_lr=1e-3, warmup=10, total=100)
    assert lr0 < lrp and lre < 0.1 * lrp


def test_optimizers_keep_the_container_kind():
    """A NamedTuple of tensors (NEPSpinParams) comes back as one."""
    from repro_torch.core.descriptor import NEPSpinSpec
    from repro_torch.core.potential import NEPSpinParams, init_params
    p = init_params(NEPSpinSpec(l_max=2, n_ang=2, n_rad=4, n_spin=3,
                                basis_size=6), torch.Generator(),
                    device="cpu")
    new, opt = adamw_update(p, p, adamw_init(p), 1e-3)
    assert isinstance(new, NEPSpinParams) and isinstance(opt.mu,
                                                         NEPSpinParams)
    state = snes_init(p)
    pop, z = snes_ask(state, torch.Generator().manual_seed(1), 4)
    assert isinstance(snes_member(pop, 0, p), NEPSpinParams)
    assert isinstance(snes_tell(state, z, torch.arange(4.0)).mean,
                      NEPSpinParams)
