"""The CI smoke scripts of the port (``launch/{engine,kernel}_smoke.py``,
``check_docs.py``, ``ci_smoke.py``) on the CPU, and the kernel wrappers'
shape-only route for meta tensors, which the dry run's LM cells take.

* ``kernel_smoke --device cpu``: the reference's spec and B20 4^3 geometry,
  no launch, the plain versions bitwise the oracle;
* ``engine_smoke --device cpu``: 2 gloo ranks, the runlog contract (halo
  records vs the run-scoped ledger, no build after the first chunk, the
  report) and a bitwise checkpoint/resume (~25 s);
* ``check_docs``: every path the docs name exists;
* ``ci_smoke.STEPS``: the port's counterpart of each ``python`` line of
  ``scripts/ci.sh --smoke`` (the scripts and ``benchmarks.run``), in its
  order, with the line's flags;
* FA's and SSD's forward and backward on meta tensors: the plain
  versions' shapes and dtypes; a tensor on another device is refused.
"""
import pathlib
import re

import pytest
import torch

from torch_one_thread import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_kernel_smoke_on_cpu():
    from repro_torch.launch import kernel_smoke
    res = kernel_smoke.main(["--device", "cpu"])
    assert res["launches"] == (0, 0)
    assert res["bodies"] == {"K1": "warp", "K2": "warp"}
    assert res["parity"] == {"E": 0.0, "F": 0.0, "H": 0.0}


def test_kernel_smoke_refuses_a_missing_card():
    from repro_torch.launch import kernel_smoke
    from repro_torch.utils import device
    real = torch.cuda.is_available
    try:
        torch.cuda.is_available = lambda: False
        with pytest.raises(RuntimeError, match="is_available"):
            kernel_smoke.main(["--device", "cuda"])
    finally:
        torch.cuda.is_available = real
    assert device.resolve_device("cpu").type == "cpu"


def test_engine_smoke_on_two_gloo_ranks():
    from repro_torch.launch import engine_smoke
    res = engine_smoke.main(["--device", "cpu"])
    assert res["ranks"] == 2 and res["chunks"] == 2
    assert res["resume_bitwise"] is True and len(res["charge"]) == 2
    assert res["halo"]["counts"]["drift-pos"] == engine_smoke.STEPS


def test_check_docs_passes():
    from repro_torch.launch import check_docs
    assert check_docs.main() == 0
    refs = list(check_docs.referenced_paths("see `src/repro/x.py` and "
                                            "docs/a.md."))
    assert refs == ["src/repro/x.py", "docs/a.md"]


def test_ci_smoke_steps_are_ci_sh_smoke_scripts():
    """Every ``python`` line of ci.sh's ``--smoke`` block, the benchmark
    registry's ``python -m benchmarks.run`` included, maps to a step, in
    order, with the line's flags."""
    from repro_torch.launch import ci_smoke
    text = (ROOT / "scripts" / "ci.sh").read_text()
    block = text[text.index('if [[ "${1:-}" == "--smoke" ]]'):]
    block = block[:block.index("\nfi\n")]
    lines = re.findall(r"python (scripts/\w+\.py|-m benchmarks\.\w+)"
                       r"([^\n\\]*)", block)
    refs = [ref if ref.startswith("scripts/")
            else ref[3:].replace(".", "/") + ".py" for ref, _ in lines]
    assert [s for s, _, _ in ci_smoke.STEPS] == refs
    assert refs[-1] == "benchmarks/run.py"
    for (script, module, _), (_, flags) in zip(ci_smoke.STEPS, lines):
        assert (ROOT / "src" / "repro_torch" / "launch"
                / f"{module}.py").exists(), module
        name = pathlib.Path(script).name
        assert name == f"{module}.py" or (
            script.startswith("benchmarks/")
            and f"bench_{name}" == f"{module}.py"), (script, module)
        assert tuple(flags.split()) == ci_smoke.ARGS.get(module, ()), module
    assert [m for _, m, dev in ci_smoke.STEPS if not dev] == ["check_docs"]


# ---------------------------------------------------------------------------
# the wrappers' shape-only route
# ---------------------------------------------------------------------------

def _like(ts, device):
    return [torch.empty(t.shape, dtype=t.dtype, device=device) for t in ts]


def _same_meta(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_meta_takes_the_plain_shapes(dtype):
    from repro_torch.kernels.attention import kernel as fa
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 24, generator=g).to(dtype)
    k = torch.randn(2, 40, 2, 24, generator=g).to(dtype)
    v = torch.randn(2, 40, 2, 16, generator=g).to(dtype)
    n_fwd, n_bwd = fa.flash_attention_fwd.launches, \
        fa.flash_attention_bwd.launches
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    do = torch.randn(o.shape, generator=g).to(dtype)
    mq, mk, mv, mo, mdo = _like((q, k, v, o, do), "meta")
    _same_meta(fa.flash_attention_fwd(mq, mk, mv, return_lse=True),
               (o, lse))
    _same_meta([fa.flash_attention_fwd(mq, mk, mv, window=8)], [o])
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do)
    _same_meta(fa.flash_attention_bwd(mq, mk, mv, mo, lse.to("meta"), mdo),
               want)
    # the autograd Function on meta leaves: the backward's shapes too
    lq, lk, lv = (t.requires_grad_(True) for t in _like((q, k, v), "meta"))
    out = fa.flash_attention(lq, lk, lv)
    grads = torch.autograd.grad(out, (lq, lk, lv), mdo)
    _same_meta(grads, want)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == (n_fwd, n_bwd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_meta_takes_the_plain_shapes(dtype):
    from repro_torch.kernels.ssd import kernel as ssd
    g = torch.Generator().manual_seed(1)
    bs, s, h, p, grp, n, chunk = 2, 32, 4, 8, 2, 16, 16
    x = torch.randn(bs, s, h, p, generator=g).to(dtype)
    dt = torch.rand(bs, s, h, generator=g)
    a = -torch.rand(h, generator=g)
    b = torch.randn(bs, s, grp, n, generator=g).to(dtype)
    c = torch.randn(bs, s, grp, n, generator=g).to(dtype)
    n0, n1 = ssd.ssd_chunks.launches, ssd.ssd_chunks_bwd.launches
    want = ssd.ssd_chunks_plain(x, dt, a, b, c, chunk=chunk)
    meta = _like((x, dt, a, b, c), "meta")
    _same_meta(ssd.ssd_chunks(*meta, chunk=chunk), want)
    cots = [torch.randn(t.shape, generator=g) for t in want]
    gwant = ssd.ssd_chunks_bwd_plain(x, dt, a, b, c, want[2], *cots,
                                     chunk=chunk)
    _same_meta(ssd.ssd_chunks_bwd(*meta, want[2].to("meta"),
                                  *_like(cots, "meta"), chunk=chunk), gwant)
    assert (ssd.ssd_chunks.launches, ssd.ssd_chunks_bwd.launches) == (n0,
                                                                      n1)


def test_other_devices_are_refused():
    """Only CPU and meta tensors take the plain route: a tensor on any
    other device that is not CUDA raises (a fake ``xpu`` tensor here)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.attention import kernel as fa
    from repro_torch.kernels.ssd import kernel as ssd
    with FakeTensorMode():
        q = torch.empty(1, 16, 2, 16, device="xpu")
        with pytest.raises(ValueError, match="CUDA, CPU or meta"):
            fa.flash_attention_fwd(q, q, q)
        with pytest.raises(ValueError, match="CUDA, CPU or meta"):
            fa.flash_attention_bwd(q, q, q, q, torch.empty(
                1, 2, 16, device="xpu"), q)
        x = torch.empty(1, 16, 2, 8, device="xpu")
        dt = torch.empty(1, 16, 2, device="xpu")
        a = torch.empty(2, device="xpu")
        bc = torch.empty(1, 16, 1, 8, device="xpu")
        with pytest.raises(ValueError, match="CUDA, CPU or meta"):
            ssd.ssd_chunks(x, dt, a, bc, bc, chunk=8)
        cum = torch.empty(1, 2, 8, 2, device="xpu")
        with pytest.raises(ValueError, match="CUDA, CPU or meta"):
            ssd.ssd_chunks_bwd(x, dt, a, bc, bc, cum, torch.empty(
                1, 2, 8, 2, 8, device="xpu"), torch.empty(
                1, 2, 2, 8, 8, device="xpu"), cum, chunk=8)
