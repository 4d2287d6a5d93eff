"""rebuilds_per_kstep: the engine's rebuild counter (``Engine.n_rebuilds``)
over the window, per thousand steps."""


def read(ctx):
    return 1e3 * ctx["counters"]["rebuilds"] / ctx["window"]["steps"]
