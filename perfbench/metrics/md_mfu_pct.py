"""md_mfu_pct: the whole step's share of the card's f32 peak: the
operations of one card's share of an evaluation (``harness/work.py``)
times the evaluations the window made (one a step, one more a rebuild),
over the window's seconds x 67 TFLOP/s."""

PEAK = 67e12


def read(ctx):
    w = ctx["window"]
    evals = w["steps"] + w["rebuilds"]
    return 100.0 * ctx["work"]["flops"] * evals / (w["seconds"] * PEAK)
