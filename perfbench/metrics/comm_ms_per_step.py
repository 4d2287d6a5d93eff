"""comm_ms_per_step: device ms of the collective kernels (NCCL's) in the
traced window over the steps: the halo exchanges, migrations, the per-step
reduction and the gathers at each run's end, waits for the other ranks
included."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ms = 1e3 * tr.device_s(lambda o: "nccl" in o.name.lower())
    return ms / ctx["window"]["steps"] if ms > 0 else None
