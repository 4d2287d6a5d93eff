"""host_syncs_per_step: the engine's ``repro.sync`` ranges in the traced
window (one a host read that blocks on the card: the skin test's, the
chunk's readback, the rebuild's binning and overflow check) over the
steps."""
from perfbench.harness import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels() or not spans.layered(tr):
        return None
    return tr.range_counts.get(spans.SYNC, 0) / ctx["window"]["steps"]
