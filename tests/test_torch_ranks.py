"""``parallel/ranks.py``: what a rank leaves behind when ``fn`` returns.

A rank's Engine on the Sharded plan sits in reference cycles that hold its
process groups.  ``_entry`` must stop those groups' gloo threads before the
process exits (a barrier, ``destroy_process_group`` and a garbage
collection): left to the interpreter's exit they aborted a rank now and
then ("terminate called without an active exception").
"""
import os

import torch
import torch.distributed as dist

from repro_torch.parallel import ranks


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


class _Cycle:
    """An object in a reference cycle, as an Engine is, holding a group."""

    def __init__(self, group):
        self.group = group
        self.me = self


def _hold_a_group(rank, out):
    out["inside"] = _threads()
    _Cycle(dist.new_group([0]))
    dist.all_reduce(torch.ones(4))


def test_entry_stops_the_groups_threads(tmp_path):
    before = _threads()
    out = {}
    ranks._entry(0, _hold_a_group, 1, "gloo", str(tmp_path / "rv"), (out,))
    assert out["inside"] > before          # the world group's threads
    assert not dist.is_initialized()
    assert _threads() == before
