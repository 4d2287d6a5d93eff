"""nep_roofline_pct: the least time one evaluation needs on the card
(``harness/work.py``: its operations at 67 TFLOP/s f32, or its bytes at
3.35 TB/s, whichever is longer) over the device time of the kernels inside
one ``repro.force`` range (the window's total over its ranges)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n = tr.range_counts.get("repro.force", 0)
    dev_s = tr.device_s(lambda o: "repro.force" in o.ranges)
    if not n or dev_s <= 0:
        return None
    return 100.0 * ctx["work"]["bound_s"] / (dev_s / n)
