"""atom_steps_per_s: atoms x steps completed in the window over the
window's seconds (host clock, ending in a synchronize)."""


def read(ctx):
    w = ctx["window"]
    return ctx["atoms"] * w["steps"] / w["seconds"]
