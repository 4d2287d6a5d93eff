"""Elastic scaling and fault-tolerance policy for long campaigns (port of
``repro.ckpt.elastic``).

1. **Node failure -> restart on another mesh.**  A Sharded Engine's
   checkpoint is one shard per rank (``rank_<r>/``, r the rank's linear
   mesh index) plus a manifest naming the writing layout.
   :func:`gather_md_state` reads every shard the writing mesh left and
   un-bins the cell blocks by their atom ids into the flat state in input
   atom order - bitwise the state the writer held - and
   ``Engine.restore(directory, plan=...)`` re-resolves the plan on the
   current ranks, re-bins, rebuilds the tables and re-evaluates the forces
   at the chunk boundary.  Lose a node, restore onto the survivors, go on.
   :func:`redecompose` re-bins a :class:`~repro_torch.parallel.domain.
   DomainState` directly.

2. **Straggler mitigation.**  The compute paths are statically balanced
   (equal cell slabs), so the knob is cadence: :class:`StragglerPolicy`
   flags steps whose wall time exceeds a multiple of the trailing median;
   :func:`straggler_chunks` feeds it a runlog's per-chunk wall times
   (``launch/report.py`` renders the result).

3. **Preemption-safe loops.**  :func:`run_resumable` wraps a step function
   with a checkpoint every N steps and an automatic restore, so a SIGTERM
   loses at most N steps (the Engine's own form is ``run(checkpoint_dir=...,
   resume=True)``, and :class:`repro_torch.resilience.Supervisor` adds
   rollback-retry on top).

Generators.  The reference hands back one saved key across an elastic
restore; the port has one ``torch.Generator`` per rank, and the number of
ranks changes.  :func:`gather_md_state` therefore derives one seed from
every saved generator state and the step (:func:`checkpoint_seed`), and the
restored rank ``r`` draws from :func:`rank_generator` ``(seed, r)`` - the
generator a fresh Sharded run seeded with ``seed`` gives rank ``r``.  A
thermostatted run is not bitwise across an elastic restore, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (latest_step, load_checkpoint,
                                         save_checkpoint)


@dataclasses.dataclass
class StragglerPolicy:
    """Flags a step as straggled when its wall time exceeds ``threshold``
    x the median of the trailing ``window`` records (after
    ``min_samples``)."""

    window: int = 50
    threshold: float = 1.5          # x median = straggler
    min_samples: int = 10           # no verdicts before this many records
    _times: list = dataclasses.field(default_factory=list)

    def record(self, step_time: float) -> bool:
        """Returns True if this step looks straggled."""
        self._times.append(step_time)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < self.min_samples:
            return False
        med = float(np.median(self._times))
        return step_time > self.threshold * med

    @property
    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


def straggler_chunks(wall_times, *, window: int = 50,
                     threshold: float = 1.5,
                     min_samples: int = 4) -> list[int]:
    """Indices of straggled chunks in a sequence of per-chunk wall times
    (a runlog's ``wall_s`` column).  A report sees the whole, often short,
    run at once, hence ``min_samples=4``; the first (warm-up) chunk is
    recorded but never flagged."""
    policy = StragglerPolicy(window=window, threshold=threshold,
                             min_samples=min_samples)
    flagged = []
    for i, w in enumerate(wall_times):
        if policy.record(float(w)) and i > 0:
            flagged.append(i)
    return flagged


def run_resumable(step_fn, state, n_steps: int, ckpt_dir: str,
                  every: int = 100, batch_fn=None, async_save: bool = True):
    """Run ``state = step_fn(state[, batch])`` with a checkpoint every
    ``every`` steps and an automatic restore of the newest one.  Returns
    ``(state, start_step_after_restore)``."""
    start = 0
    if latest_step(ckpt_dir) is not None:
        state, start = load_checkpoint(ckpt_dir, state)
        start += 1
    policy = StragglerPolicy()
    for i in range(start, n_steps):
        t0 = time.time()
        batch = batch_fn(i) if batch_fn else None
        state = step_fn(state, batch) if batch is not None else step_fn(state)
        if policy.record(time.time() - t0):
            print(f"[elastic] step {i}: straggler detected "
                  f"({time.time() - t0:.3f}s vs median "
                  f"{policy.median:.3f}s)")
        if (i + 1) % every == 0 or i == n_steps - 1:
            save_checkpoint(ckpt_dir, i, state, async_=async_save)
    return state, start


def redecompose(dspec_old, dspec_new, dstate):
    """Re-bin a DomainState onto a new cell grid (an elastic rescale):
    unpack to flat atom arrays on the host, pack with ``dspec_new``."""
    from repro_torch.parallel.domain import pack_domain, unpack_domain
    pos, vel, spin, types = unpack_domain(dstate)
    return pack_domain(dspec_new, pos, vel, spin, types)


# ---------------------------------------------------------------------------
# elastic restore of Sharded Engine checkpoints
# ---------------------------------------------------------------------------

def checkpoint_seed(gen_states, step: int) -> int:
    """One seed from every rank's saved generator state (uint8 arrays, in
    rank order) and the checkpoint's step."""
    words = [np.uint32(step)]
    for g in gen_states:
        b = np.asarray(g, np.uint8).reshape(-1)
        b = np.concatenate([b, np.zeros((-b.size) % 4, np.uint8)])
        words.extend(b.view(np.uint32))
    seq = np.random.SeedSequence(np.asarray(words, np.uint32))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rank_generator(seed: int, rank: int, device="cuda") -> torch.Generator:
    """Rank ``rank``'s ``torch.Generator`` of a Sharded run seeded with
    ``seed`` (``SeedSequence([seed, rank])``)."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(state >> np.uint64(1)))


def gather_md_state(directory: str, shard_like, *, step: int | None = None,
                    device="cpu"):
    """Load a Sharded Engine checkpoint, written on any mesh, into the
    canonical flat form.

    ``shard_like`` is a rank's checkpoint tree of the target engine
    (``Engine._domain_ckpt_tree``): the structure is the same on every
    mesh, only the leaves' shapes differ.  Reads the step's manifest (the
    writer's layout: ranks, cells, K, local cells, replicas) and every
    ``rank_<r>/`` shard, and un-bins the cell blocks by the carried atom
    ids.  Returns ``(state, seed, step)``: a flat
    :class:`~repro_torch.md.state.SpinLatticeState` on ``device`` with the
    checkpoint's box and step - bitwise the writer's state in input atom
    order - and :func:`checkpoint_seed` of the saved generators (None when
    the run saved none)."""
    from repro_torch.md.state import SpinLatticeState

    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    tree, _ = load_checkpoint(directory, {"layout": np.zeros(9, np.int64)},
                              step=step, strict_shapes=False)
    layout = np.asarray(tree["layout"])
    ranks = int(layout[0])
    replicas = int(layout[8]) if layout.size > 8 else 0
    if replicas:
        raise NotImplementedError(
            "elastic restore supports single-trajectory sharded carries; "
            f"this checkpoint holds {replicas} replicas (replica-sharded "
            "checkpoints: restore per replica)")
    template = {"carry": shard_like, "generator": np.zeros(0, np.uint8)}
    shards, gens = [], []
    for r in range(ranks):
        got, _ = load_checkpoint(os.path.join(directory, f"rank_{r:05d}"),
                                 template, step=step, strict_shapes=False)
        shards.append(got["carry"])
        g = np.asarray(got["generator"])
        if g.size:
            gens.append(g)

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    aid = np.concatenate([host(s["aid"]).reshape(-1) for s in shards])
    sel = np.nonzero(aid >= 0)[0]
    order = np.empty(sel.size, np.int64)
    order[aid[sel]] = sel

    def flat(name, tail):
        rows = np.concatenate([host(s["state"]._asdict()[name]).reshape(
            (-1,) + tail) for s in shards])
        return torch.from_numpy(rows[order]).to(device)

    st0 = shards[0]["state"]
    state = SpinLatticeState(
        pos=flat("pos", (3,)), vel=flat("vel", (3,)), spin=flat("spin", (3,)),
        types=flat("types", ()).to(torch.int32),
        box=torch.as_tensor(host(st0.box)).to(device), step=int(st0.step))
    return state, (checkpoint_seed(gens, step) if gens else None), step
