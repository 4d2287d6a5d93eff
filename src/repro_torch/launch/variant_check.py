#!/usr/bin/env python3
"""Two design choices of the kernels, measured against the road not
taken, on the card.

    PYTHONPATH=src python3 -m repro_torch.launch.variant_check

Each variant is a copy of a kernel source with one block rewritten,
built beside the real source (``_build.SOURCES`` pointed at the copy, in
the same process) and run in turns with it (kept, variant, variant, kept)
on the same inputs, against the kernel's plain version:

* ``ssd_hi_only``: SSD's tensor-core body (``kernels/ssd/csrc/
  ssd_chunks.cu``) multiplies x by W and by B o dte, each split into bf16
  hi and lo = bf16(v - hi) halves; the variant drops the four lo products
  (the lines marked ``// lo``).  Inputs as ``chip_smoke.py`` phase 9 draws
  them (Zamba2-2.7B prefill: B = 2, S = 8,192, 80 heads of 64, state 64,
  chunk 128, bf16); the bar there is 5e-4 of each output's max |ref|.
* ``k1_shuffle_sums``: K1's warp body (``kernels/nep/csrc/
  nep_atom_pass.cu``) sums its 182 accumulators by a transpose through
  shared memory (lane j owns accumulators j, j + 32, ...); the variant
  has each lane take its own pair's 182 products and sums each over the
  warp with shuffle butterflies.  Inputs: 262,144 atoms of B20 FeGe (32^3
  cells, 0.08 A jitter, random spins), the production spec, f32; the bar
  is 1e-4.

Prints each variant's errors and times (CUDA events, 20 launches), the
card's name and power limit, and one JSON line.  Needs one CUDA card and
nvcc.
"""
from __future__ import annotations

import json
import subprocess
import sys

K1_TRANSPOSE = """\
      for (int p = 0; p < cnt; ++p) {
        const T* rp = rec + p * R::LD;
#pragma unroll
        for (int t = 0; t < R::T; ++t) acc[t] += rp[f1[t]] * rp[f2[t]];
      }
"""
K1_SHUFFLE = """\
      {
        T v[R::W];
#pragma unroll
        for (int j = 0; j < R::W; ++j)
          v[j] = lane < cnt ? rec[lane * R::LD + j] : T(0);
#pragma unroll
        for (int k = 0; k < A; ++k) {
          int g1, g2;
          acc_factors<S>(k, g1, g2);
          T x = v[g1] * v[g2];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(full, x, off);
          if (lane == k % 32) acc[k / 32] += x;
        }
      }
"""


def _ssd_hi_only(text: str) -> str:
    kept = [ln for ln in text.splitlines()
            if not ln.rstrip().endswith("// lo")]
    if len(text.splitlines()) - len(kept) != 4:
        raise AssertionError("expected 4 lo products in ssd_chunks.cu")
    return "\n".join(kept) + "\n"


def _k1_shuffle(text: str) -> str:
    if text.count(K1_TRANSPOSE) != 1:
        raise AssertionError("K1's transpose loop not found once")
    return text.replace(K1_TRANSPOSE, K1_SHUFFLE)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 20


def _ssd_case(torch, dev):
    from repro_torch.kernels.ssd import kernel as ssd
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(4)
    B, S, H, P, N, L = 2, 8192, 80, 64, 64, 128
    d_in = H * P
    xbc = torch.randn((B, S, d_in + 2 * N), generator=gen, device=dev,
                      dtype=torch.bfloat16)
    args = (xbc[..., :d_in].view(B, S, H, P),
            F.softplus(torch.randn((B, S, H), generator=gen, device=dev)),
            -torch.linspace(1.0, 16.0, H, device=dev),
            xbc[..., d_in:d_in + N].view(B, S, 1, N),
            xbc[..., d_in + N:].view(B, S, 1, N))
    want = ssd.ssd_chunks_plain(*args, chunk=L)
    return ("y_intra", "states", "cum"), want, \
        lambda: ssd.ssd_chunks(*args, chunk=L, body="tc")


def _k1_case(torch, dev):
    from repro_torch.configs.fege_spinlattice import config
    from repro_torch.core.potential import init_params
    from repro_torch.kernels.nep import kernel as kern
    from repro_torch.kernels.nep import ref
    from repro_torch.md.lattice import b20_fege
    from repro_torch.md.neighbor import cell_neighbor_table, gather_blocks
    from repro_torch.md.state import init_state
    spec = config().spec
    gen = torch.Generator(device=dev).manual_seed(11)
    st = init_state(b20_fege(), (32, 32, 32), generator=gen,
                    spin_init="random", dtype=torch.float32, device=dev)
    pos = torch.remainder(st.pos + 0.08 * torch.randn(
        st.pos.shape, generator=gen, device=dev), st.box)
    params = init_params(spec, gen, dtype=torch.float32, device=dev)
    nbh = gather_blocks(pos, st.types, cell_neighbor_table(
        pos, st.box, spec.cutoff, 64, cell_capacity=32), st.box)
    blocks = (nbh.dr, nbh.mask, st.types, nbh.tj, st.spin,
              st.spin[nbh.idx.long()])
    want = ref.atom_pass_plain(spec, params, *blocks)
    return ("e", "hdir", "abar"), want, \
        lambda: kern.nep_atom_pass(spec, params, *blocks, body="warp")


VARIANTS = {   # name: (library, rewrite, inputs, mangled name of the body)
    "ssd_hi_only": ("ssd_chunks", _ssd_hi_only, _ssd_case,
                    "ssd_chunk_tc_kernelILi4ELi8ELb1E"),
    "k1_shuffle_sums": ("nep_atom_pass", _k1_shuffle, _k1_case,
                        "atom_pass_warp_kernelINS_5SizesILi2ELi8ELi6ELi4ELi4"
                        "ELi4ELi32ELi3EEEfE"),
}


def _ptxas(log: str, key: str) -> str:
    """ptxas's stack / spill and register lines for the entry ``key``."""
    lines, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln
        elif cur and key in cur and ("stack frame" in ln or "Used" in ln):
            lines.append(ln.split(":", 1)[-1].strip())
    return "; ".join(lines)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("variant_check: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import _build
    dev = torch.device("cuda")
    out = {}
    for name, (lib, rewrite, case, key) in VARIANTS.items():
        src = _build.SOURCES[lib]
        copy = src.with_name(f"{src.stem}_{name}.cu")   # beside its headers
        copy.write_text(rewrite(src.read_text()))
        try:
            outputs, want, run = case(torch, dev)
            res = {"kept": {"ms": []}, "variant": {"ms": []}}
            for side in ("kept", "variant", "variant", "kept"):
                _build.SOURCES[lib] = src if side == "kept" else copy
                _build._loaded.pop(lib, None)
                got = run()
                torch.cuda.synchronize()
                for o, u, w in zip(outputs, got, want):
                    res[side][o] = _rel(u, w)
                res[side]["ms"].append(_ms(torch, run))
                log = _build.library_path(lib).with_suffix(".log")
                res[side]["ptxas"] = _ptxas(log.read_text(), key)
        finally:
            _build.SOURCES[lib] = src
            _build._loaded.pop(lib, None)
            copy.unlink()
        out[name] = res
        for side, r in res.items():
            errs = " ".join(f"{o} {r[o]:.3e}" for o in outputs)
            print(f"{name} {side:8} {errs}; ms {r['ms']}; ptxas "
                  f"{r['ptxas']}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
