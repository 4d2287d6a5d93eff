"""rebuild_ms_per_step: device ms of the kernels launched inside the
engine's ``repro.rebuild`` ranges (ordering, table build, gather; the
evaluation that follows is ``force_ms_per_step``'s) over the steps."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels():
        return None
    ms = 1e3 * tr.device_s(lambda o: "repro.rebuild" in o.ranges
                           and "repro.force" not in o.ranges)
    return ms / ctx["window"]["steps"]
