"""Multi-replica spin-lattice ensemble: a facade over the engine (port of
``repro.ensemble.replica``).

The replica loop lives in :class:`repro_torch.md.engine.Engine` on the
:class:`~repro_torch.parallel.plan.Replicated` plan: a
:class:`~repro_torch.md.state.SpinLatticeState` batched over a leading
replica axis, one shared neighbor table (crystalline FeGe barely diffuses)
rebuilt from the replica-mean positions when any replica trips the
half-skin test, a per-replica ``dr`` block, K1 and K2 launched once for all
replicas, and one ``torch.Generator`` per replica.

This facade adds the between-chunk ensemble features: parallel-tempering
replica exchange over a temperature ladder every ``exchange_every`` chunks
(:mod:`repro_torch.ensemble.exchange`), per-chunk callbacks, and the
per-chunk :class:`EnsembleTrace` of the paper's Fig. 4/9 observables.
:meth:`ReplicaEnsemble.shard` splits the replica axis over ranks (each
holds R / ranks replicas and their generators; a tempering exchange
gathers the batch, every rank makes the same swap decisions from the same
uniforms and keeps its own rows).

For systems too large for one card, :func:`run_sharded_sweep` runs a (T, B)
sweep on the Sharded plan with replicas: every replica is a full spatial
decomposition of the crystal, on a ``("replica", "sx")`` mesh from
:func:`sharded_replica_mesh`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.ensemble import protocol
from repro_torch.ensemble.exchange import apply_exchange
from repro_torch.md.engine import Engine
from repro_torch.md.integrator import ForceField, IntegratorConfig
from repro_torch.md.neighbor import NeighborTable
from repro_torch.md.state import (SpinLatticeState, replicate, stack_states,
                                  unstack_state)
from repro_torch.parallel.plan import Replicated, Sharded

__all__ = ["EnsembleTrace", "ReplicaEnsemble", "replicate", "stack_states",
           "unstack_state", "spawn_generators", "sharded_replica_mesh",
           "run_sharded_sweep"]


class EnsembleTrace(NamedTuple):
    """Per-chunk diagnostics, stacked over chunks (C) x replicas (R)."""

    time: np.ndarray           # (C,) ps at chunk ends
    temperature: np.ndarray    # (C, R) applied bath temperature [K]
    charge: np.ndarray         # (C, R) Berg-Luscher topological charge
    magnetization: np.ndarray  # (C, R) <S_z> over magnetic sites
    pitch: np.ndarray          # (C, R) helix pitch [A]
    energy: np.ndarray         # (C, R) potential energy [eV]
    exchange_accepts: int
    exchange_attempts: int


def spawn_generators(seed: int, n: int, device="cuda") -> list:
    """``n`` independent ``torch.Generator`` streams on ``device`` from one
    seed (numpy ``SeedSequence.spawn``): one per replica or slot."""
    return [torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        for s in np.random.SeedSequence(seed).spawn(n)]


def _as_schedule(value, default) -> protocol.Schedule:
    if value is None:
        return protocol.constant(default)
    if isinstance(value, protocol.Schedule):
        return value
    return protocol.constant(value)


@dataclasses.dataclass
class ReplicaEnsemble:
    """Replica-batched analogue of :class:`repro_torch.md.simulate.
    Simulation`.

    ``states`` must be replica-batched (:func:`replicate`); ``types`` and
    ``box`` are the same in every replica (one crystal), so one neighbor
    table and one set of its static blocks serve the whole batch.  The
    potential must expose the gather-once ``compute`` surface.
    """

    potential: Any
    cfg: IntegratorConfig
    states: SpinLatticeState       # (R, N, ...)
    masses: torch.Tensor           # (n_types,)
    magnetic: torch.Tensor         # (n_types,) bool
    cutoff: float
    capacity: int = 64
    skin: float = 0.5
    use_cell_list: bool = False
    cell_capacity: int = 24
    diag_grid: tuple[int, int] = (32, 32)
    pitch_bins: int = 64
    table: NeighborTable | None = None
    device: Any = "cuda"
    _ffs: ForceField | None = None

    def __post_init__(self):
        if self.states.pos.dim() != 3:
            raise ValueError("states must be replica-batched (R, N, 3); "
                             "use ensemble.replica.replicate()")
        if not hasattr(self.potential, "compute"):
            raise ValueError("ReplicaEnsemble drives the fused loop and "
                             "needs a potential with .compute()")
        self._engine = Engine(
            potential=self.potential, cfg=self.cfg, state=self.states,
            masses=self.masses, magnetic=self.magnetic, cutoff=self.cutoff,
            plan=Replicated(self.states.pos.shape[0]),
            observables=("energy", "magnetization", "charge", "pitch"),
            capacity=self.capacity, skin=self.skin,
            use_cell_list=self.use_cell_list,
            cell_capacity=self.cell_capacity, diag_grid=self.diag_grid,
            pitch_bins=self.pitch_bins, table=self.table, device=self.device)
        self._pull()

    def _pull(self):
        self.states = self._engine.state
        self._ffs = self._engine._ff
        self.table = self._engine.table

    # ------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return self.states.pos.shape[0]

    @property
    def energies(self) -> torch.Tensor:
        """Per-replica potential energy (R,) at the current state."""
        return self._ffs.energy

    @property
    def time(self) -> float:
        """Simulated time [ps] (replicas advance in lockstep)."""
        return float(self.states.step[0]) * self.cfg.dt

    def shard(self, devices=None) -> "ReplicaEnsemble":
        """Split the replica axis over the ranks ``devices`` names (a
        ``DeviceMesh`` or ranks; every rank of the world calls it): each
        holds R / ranks replicas and takes that many generators in
        :meth:`run`.  A no-op for one rank."""
        self._engine.shard_replicas(devices)
        self._pull()
        return self

    # ------------------------------------------------------------------
    def run(self, n_steps: int, generators, *, temperature=None, field=None,
            chunk: int = 100, exchange_every: int = 0,
            exchange_generator: torch.Generator | None = None,
            callback: Callable[["ReplicaEnsemble"], None] | None = None,
            ) -> EnsembleTrace:
        """Advance every replica ``n_steps`` under the given protocol,
        replica r drawing its noise from ``generators[r]``.

        temperature: None (-> cfg.temperature), scalar, (R,) ladder, or a
            :class:`~repro_torch.ensemble.protocol.Schedule` (values (K,)
            shared or (K, R)).
        field: None (-> zero field), (3,) Tesla, (R, 3), or a Schedule
            (values (K, 3) shared or (K, R, 3)).
        exchange_every: if > 0, attempt parallel-tempering swaps every that
            many chunks, with uniforms from ``exchange_generator`` (a CPU
            generator); the temperature must then be a constant (R,)
            ladder.
        Returns the per-chunk :class:`EnsembleTrace`.
        """
        r = self.n_replicas
        eng = self._engine
        tsched = _as_schedule(temperature, self.cfg.temperature)
        fsched = _as_schedule(field, np.zeros((3,), np.float32))
        generators = list(generators)
        if len(generators) != eng._batch:
            raise ValueError(f"{eng._batch} replicas on this process need "
                             f"{eng._batch} generators, got "
                             f"{len(generators)}")
        if exchange_every:
            ladder = np.asarray(tsched.values)
            if ladder.ndim != 2 or ladder.shape[1] != r or \
                    not np.allclose(ladder[0], ladder[-1]):
                raise ValueError("replica exchange needs a constant (R,) "
                                 "temperature ladder")
            if exchange_generator is None:
                raise ValueError("replica exchange needs exchange_generator")
            ladder = ladder[0].astype(np.float64)

        # the caller may have moved ``states`` between runs (moves below
        # half the skin never trip the rebuild): refresh dr at the current
        # positions and evaluate at the protocol's starting field
        eng.state = self.states
        eng._replica_resync(fsched)
        targ = eng._norm_arg(tsched, vec=False)
        farg = eng._norm_arg(fsched, vec=True)

        rows, times, temps_log = [], [], []
        n_acc = n_att = 0
        done = n_chunks = 0
        parity = 0
        while done < n_steps:
            n = min(chunk, n_steps - done)
            carry, obs, _ = eng._replica_chunk(
                eng._carry, generators,
                eng._chunk_arg(targ, eng._carry, n, vec=False),
                eng._chunk_arg(farg, eng._carry, n, vec=True), n, None)
            eng._carry = carry
            done += n
            n_chunks += 1
            rows.append({k: v[0].detach().cpu().numpy()
                         for k, v in obs.items()})
            t_now = float(carry.states.step[0]) * self.cfg.dt
            times.append(t_now)
            temps_log.append(np.broadcast_to(
                np.asarray(tsched.at(t_now)), (r,)).copy())
            if exchange_every and n_chunks % exchange_every == 0:
                # split over ranks, every rank gathers the batch and makes
                # the same swaps (same energies, same uniforms); the
                # resync keeps its own rows
                states, ffs = eng._full_batch(carry)
                states, ffs, acc, att = apply_exchange(
                    states, ffs, ladder, parity,
                    generator=exchange_generator)
                # dr rows travel with their configuration: the resync
                # re-derives dr and forces from the permuted positions
                eng.state = states
                eng._replica_resync(fsched)
                n_acc += acc
                n_att += att
                parity ^= 1
            if callback is not None:
                eng._sync_replica()
                self._pull()
                callback(self)
                if self.states is not eng.state:   # the callback swapped it
                    eng.state = self.states
                    eng._replica_resync(fsched)

        eng._sync_replica()
        self._pull()
        return EnsembleTrace(
            time=np.asarray(times), temperature=np.stack(temps_log),
            charge=np.stack([row["charge"] for row in rows]),
            magnetization=np.stack([row["magnetization"][:, 2]
                                    for row in rows]),
            pitch=np.stack([row["pitch"] for row in rows]),
            energy=np.stack([row["energy"] for row in rows]),
            exchange_accepts=n_acc, exchange_attempts=n_att)


# ---------------------------------------------------------------------------
# the replica axis composed with the spatial mesh (the Sharded plan)
# ---------------------------------------------------------------------------

def sharded_replica_mesh(replica_shards: int, spatial: int,
                         replica_axis: str = "replica",
                         spatial_axis: str = "sx"):
    """2-D ``DeviceMesh`` ``(replica_axis, spatial_axis)`` over the first
    ``replica_shards * spatial`` ranks of the initialised world: each
    replica shard owns a full spatial decomposition, halos and spatial
    reductions run over ``spatial_axis`` only, replicas never exchange
    halos.  Every rank of the world calls it (making a mesh is a
    collective); raises when the world is smaller."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = replica_shards * spatial
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(need).reshape(replica_shards,
                                                      spatial),
                      mesh_dim_names=(replica_axis, spatial_axis))


def run_sharded_sweep(potential, cfg, state, masses, magnetic, cutoff,
                      temperatures, fields=None, *, n_steps: int = 1000,
                      generators=None, chunk: int = 100, mesh=None,
                      observables=("energy", "kinetic", "magnetization",
                                   "charge"),
                      **engine_kw):
    """(T, B) sweep on the domain-decomposed loop: every replica is a full
    spatial decomposition of the same crystal, stepped at its own
    ``(temperature, field)`` point in one Sharded Engine with
    ``replicas=R`` (on ``mesh``, e.g. :func:`sharded_replica_mesh`; None:
    the 1-D mesh over the world, every rank holding every replica).

    ``temperatures`` is (R,) [K] or a
    :class:`~repro_torch.ensemble.protocol.Schedule` (values (K,) shared or
    (K, R) per replica); ``fields`` likewise ((R, 3) Tesla or a Schedule).
    ``generators`` are this rank's, one per local replica (default: from
    :func:`repro_torch.ckpt.elastic.rank_generator` with seed 0, one per
    (rank, local replica)).  Every rank calls it with the same flat
    ``state``.  Returns ``(engine, trace)``, the per-chunk, per-replica
    :class:`~repro_torch.md.engine.EngineTrace` ((C, R) values, reduced
    over the spatial ranks, on every rank)."""
    if isinstance(temperatures, protocol.Schedule):
        temps = temperatures
        tv = np.asarray(temps.values)
        r = tv.shape[1] if tv.ndim == 2 else None
    else:
        temps = np.asarray(temperatures, np.float64).reshape(-1)
        r = temps.shape[0]
    if r is None:   # a shared temperature schedule: R from the fields
        if isinstance(fields, protocol.Schedule):
            fv = np.asarray(fields.values)
            r = fv.shape[1] if fv.ndim == 3 else None
        elif fields is not None and np.ndim(fields) == 2:
            r = np.shape(fields)[0]
    if r is None:
        raise ValueError("shared schedules do not define the replica "
                         "count; pass per-replica temperature values "
                         "(K, R) or per-replica fields (R, 3)")
    if fields is not None and not isinstance(fields, protocol.Schedule):
        fields = np.array(np.broadcast_to(np.asarray(fields, np.float64),
                                          (r, 3)))
    engine = Engine(
        potential=potential, cfg=cfg, state=state, masses=masses,
        magnetic=magnetic, cutoff=cutoff,
        plan=Sharded(mesh=mesh, replicas=r), temperature=temps,
        field=fields, observables=observables, **engine_kw)
    if generators is None:
        from repro_torch.ckpt.elastic import rank_generator
        rank = engine._rplan.rank
        generators = [rank_generator(0, rank * engine._batch + j,
                                     engine.device)
                      for j in range(engine._batch)]
    engine.run(n_steps, generators, chunk=chunk)
    return engine, engine.trace
