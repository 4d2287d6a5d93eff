"""force_idle_ms_per_step: ms a step the card sat idle while the host was
in an evaluation (innermost layer span ``repro.force``: the neighbor-spin
gather, K1, K2, the Zeeman term; :mod:`perfbench.harness.spans`)."""
from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("repro.force",))
