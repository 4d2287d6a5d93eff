"""force_ms_per_step: device ms of the kernels launched inside the
engine's ``repro.force`` ranges (the neighbor-spin gather, K1, K2, the
Zeeman term) over the steps."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels():
        return None
    return 1e3 * tr.device_s(lambda o: "repro.force" in o.ranges) / ctx[
        "window"]["steps"]
