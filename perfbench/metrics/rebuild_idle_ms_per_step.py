"""rebuild_idle_ms_per_step: ms a step the card sat idle while the host
was in a neighbor-table rebuild (innermost layer span ``repro.rebuild``;
:mod:`perfbench.harness.spans`)."""
from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("repro.rebuild",))
