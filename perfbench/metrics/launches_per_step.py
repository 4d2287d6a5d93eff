"""launches_per_step: device kernels in the traced window over the steps
the window ran (one step of the engine's loop, all replicas)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels():
        return None
    return len(tr.kernels()) / ctx["window"]["steps"]
