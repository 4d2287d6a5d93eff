"""halo_mb_per_step: the bytes a rank's halo exchanges moved over the
window (the Sharded plan's ledger, ``Engine.halo_ledger``: every exchange
and fold, migrations with them), in MB (10^6 bytes) a step."""


def read(ctx):
    moved = ctx["counters"].get("halo_bytes")
    if moved is None:
        return None
    return moved / 1e6 / ctx["window"]["steps"]
