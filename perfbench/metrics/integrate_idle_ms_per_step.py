"""integrate_idle_ms_per_step: ms a step the card sat idle while the host
was dispatching the integrator (innermost layer span ``repro.integrate``
or its ``repro.refresh``, not ``repro.force``;
:mod:`perfbench.harness.spans`)."""
from perfbench.harness import spans


def read(ctx):
    return spans.idle_ms_per_step(ctx, ("repro.integrate", "repro.refresh"))
