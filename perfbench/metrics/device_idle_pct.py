"""device_idle_pct: the share of the traced window in which no operation
ran on the card (one minus the union of the device operations' intervals
over the window)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.kernels() or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
