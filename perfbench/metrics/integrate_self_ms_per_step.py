"""integrate_self_ms_per_step: device ms of the kernels launched inside the
engine's ``repro.integrate`` ranges but outside ``repro.force`` (the
integrator's own elementwise work and the position refresh) over the
steps."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels():
        return None
    ms = 1e3 * tr.device_s(lambda o: "repro.integrate" in o.ranges
                           and "repro.force" not in o.ranges)
    return ms / ctx["window"]["steps"]
