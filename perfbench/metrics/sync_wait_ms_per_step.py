"""sync_wait_ms_per_step: host ms inside the engine's ``repro.sync``
ranges over the steps: how long the host blocks on the card."""
from perfbench.harness import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels() or not spans.layered(tr):
        return None
    return 1e3 * spans.host_s(tr, spans.SYNC) / ctx["window"]["steps"]
