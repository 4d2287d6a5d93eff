"""Train a ~100M-parameter LM of the zoo for a few hundred steps on
synthetic data (port of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --arch qwen2-7b \\
        --steps 200 [--ckpt-dir ckpts] [--device cpu]

The full configs are production scale; this driver scales the chosen
family's smoke config to ~100M parameters (d_model 512, 8 layers, d_ff
2,048, vocab 32,000, 8 heads of 64 over up to 4 kv heads), keeping what
distinguishes it (GQA + bias for qwen2, MoE routing for deepseek /
moonshot, the window for h2o, SSD for mamba2, SSD and the shared attention
block for zamba2, ...), and runs ``launch/train.py``'s
``train_lm`` on it.  Interrupt and rerun with the same ``--ckpt-dir`` to
resume.
"""
from __future__ import annotations

import argparse
import dataclasses

SCALE = dict(d_model=512, n_layers=8, d_ff=2048, vocab=32000)


def hundred_m_config(arch: str):
    """``arch``'s smoke config at the ~100M-parameter scale."""
    from repro_torch import configs
    cfg = configs.get_smoke(arch)
    scale = dict(SCALE)
    if cfg.n_heads:
        scale["n_heads"] = 8
        scale["kv_heads"] = max(1, min(cfg.kv_heads, 4))
        scale["head_dim"] = 64
    return dataclasses.replace(cfg, **{k: v for k, v in scale.items()
                                       if hasattr(cfg, k)})


def main(argv=None) -> dict:
    from repro_torch.launch.train import train_lm
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.smoke = False
    args.log_every = 10
    args.ckpt_every = 50
    return train_lm(args, cfg_override=hundred_m_config(args.arch))


if __name__ == "__main__":
    main()
