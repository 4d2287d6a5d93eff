"""loop_idle_ms_per_step: ms a step the card sat idle while the host was
in the chunk loop itself (innermost layer span ``repro.run``,
``repro.chunk``, ``repro.step``, ``repro.skin_test``, ``repro.readback``
or ``repro.observe``; :mod:`perfbench.harness.spans`)."""
from perfbench.harness import spans

NAMES = ("repro.run", "repro.chunk", "repro.step", "repro.skin_test",
         "repro.readback", "repro.observe")


def read(ctx):
    return spans.idle_ms_per_step(ctx, NAMES)
