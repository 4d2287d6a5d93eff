"""Halo (ghost-layer) exchange for the spatial domain decomposition (port
of ``repro.parallel.halo``).

The paper's MPI halo exchange on ``torch.distributed``: one message pair per
sharded spatial axis, axes processed in turn on the already-extended block,
so edge and corner ghosts propagate (6 messages instead of 26).  A block is
``(cx, cy, cz, ...)``; each sharded axis is a :class:`HaloAxis`, a mesh
dimension as this rank sees it.

* ppermute mode: ``batch_isend_irecv`` of the two face layers with the two
  neighbours along the axis's group;
* allgather mode: ONE ``all_gather`` of both face layers per axis (wire
  volume 2(n-1) layers instead of 2, one rendezvous) - the reference's
  ``auto`` choice when every sharded axis is at most 8 wide;
* an unsharded axis, or a sharded one of size 1, is the periodic wrap of
  the local block itself (a one-device ``ppermute`` is the identity).

:func:`exchange_halo_multi` packs every field into one buffer, so an axis
costs one message round however many fields ride along (integer fields ride
the float payload, exact below the mantissa bound).  :func:`fold_halo` is
the adjoint: ghost-layer contributions travel back to their owners and are
added onto the core block (the force / field "reverse communication").  A
block may carry leading batch dims before its cells (the Sharded plan's
local replicas): ``dims`` names the cell dims, and every replica rides the
same message.

gloo takes CUDA tensors in ``all_gather`` but has no send/recv of device
tensors, so a ppermute-mode exchange of CUDA tensors under gloo raises.

Instrumentation: every exchange and fold records its tag and per-rank
message bytes into every active :class:`HaloTrace` (a context manager; the
Engine opens one per run) at each CALL, so ``counts[tag]`` over a run of n
steps is n times the exchanges a step makes.  A tagged exchange or fold
also runs in a ``repro.halo.<tag>`` profiler range; an asynchronous
exchange opens it twice, once to issue its messages and once in ``wait()``,
so a trace names the exchange a rank waits at.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.telemetry.profiling import annotate

# Per-step steady-state exchange tags: one occurrence each makes the
# per-step wire estimate (rebuild and migration tags run on rebuilds only)
STEP_TAGS = ("drift-pos", "spin", "adjoint", "qfp")


@dataclasses.dataclass
class HaloTrace:
    """Exchange ledger: tag -> (#exchange calls, message bytes per rank).

    Active while installed as a context manager (ledgers nest; a record
    tees into all of them)::

        with ledger:
            engine_chunk(...)
    """

    counts: dict = dataclasses.field(default_factory=dict)
    bytes: dict = dataclasses.field(default_factory=dict)

    def record(self, tag: str, n_bytes: int):
        self.counts[tag] = self.counts.get(tag, 0) + 1
        self.bytes[tag] = self.bytes.get(tag, 0) + n_bytes

    def __enter__(self) -> "HaloTrace":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        for i in range(len(_ACTIVE) - 1, -1, -1):
            if _ACTIVE[i] is self:
                del _ACTIVE[i]
                break

    def per_exchange_bytes(self) -> dict:
        """tag -> per-rank bytes one occurrence of the exchange moves."""
        return {t: self.bytes[t] // max(self.counts.get(t, 1), 1)
                for t in self.bytes}

    def per_step_bytes(self) -> int:
        """Per-rank halo bytes of one steady-state step: one occurrence of
        each :data:`STEP_TAGS` exchange."""
        per = self.per_exchange_bytes()
        return int(sum(per.get(t, 0) for t in STEP_TAGS))

    def snapshot(self) -> dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes),
                "bytes_per_step": self.per_step_bytes()}


_ACTIVE: list[HaloTrace] = []


def record(tag: str, n_bytes: int) -> None:
    """Record one collective of ``n_bytes`` per rank under ``tag`` into
    every active ledger (the exchanges and folds below call it; so does the
    legacy paths' energy reduction)."""
    for ledger in _ACTIVE:
        ledger.record(tag, n_bytes)


@dataclasses.dataclass(frozen=True)
class HaloAxis:
    """A sharded mesh dimension as one rank sees it."""

    name: str
    size: int
    index: int              # this rank's coordinate along the dimension
    group: Any = None       # its process group (None when size == 1)
    ranks: tuple = ()       # global ranks of the group, by coordinate

    def peer(self, shift: int) -> int:
        """Global rank of the coordinate ``index + shift`` (periodic)."""
        return self.ranks[(self.index + shift) % self.size]


def halo_axes(mesh, axis_map) -> tuple:
    """Per spatial dim the :class:`HaloAxis` of ``axis_map``'s mesh
    dimension, or None where the dim is not sharded.  ``mesh`` None (no
    process group) makes every named dimension a size-1 axis."""
    out = []
    for name in axis_map:
        if name is None:
            out.append(None)
        elif mesh is None:
            out.append(HaloAxis(name, 1, 0))
        else:
            import torch.distributed as dist
            group = mesh.get_group(name)
            out.append(HaloAxis(name, dist.get_world_size(group),
                                mesh.get_local_rank(name), group,
                                tuple(dist.get_process_group_ranks(group))))
    return tuple(out)


def _communicates(ax: HaloAxis | None) -> bool:
    return ax is not None and ax.size > 1


def _message_bytes(x: torch.Tensor, dims, axes, width: int,
                   allgather: bool = False) -> int:
    """Per-rank bytes one exchange of ``x`` moves over its sharded axes:
    each axis' face includes the previous axes' ghosts; in allgather mode a
    rank receives 2w(n-1) face layers instead of the ppermute pair's 2w."""
    total = 0
    shape = list(x.shape)
    for d, ax in zip(dims, axes):
        if ax is not None:
            face = int(np.prod([s for i, s in enumerate(shape) if i != d]))
            layers = 2 * width
            if allgather:
                layers = 2 * width * max(ax.size - 1, 1)
            total += layers * face * x.element_size()
        shape[d] += 2 * width
    return total


# ---------------------------------------------------------------------------
# forward exchange
# ---------------------------------------------------------------------------

def _start_axis(x: torch.Tensor, dim: int, ax: HaloAxis | None, width: int,
                allgather: bool) -> Callable[[], torch.Tensor]:
    """Issue the exchange of ``x``'s two face layers along ``dim``; the
    returned callable waits and returns ``x`` extended by ``width`` ghost
    layers on both sides."""
    n_d = x.shape[dim]
    first = x.narrow(dim, 0, width)
    last = x.narrow(dim, n_d - width, width)
    if not _communicates(ax):
        return lambda: torch.cat([last, x, first], dim=dim)
    import torch.distributed as dist
    if allgather:
        layers = torch.cat([first, last], dim=dim).contiguous()
        n, i = ax.size, ax.index
        got = [torch.empty_like(layers) for _ in range(n)]
        work = dist.all_gather(got, layers, group=ax.group, async_op=True)

        def finish():
            work.wait()
            lo = got[(i - 1) % n].narrow(dim, width, width)  # (i-1)'s last
            hi = got[(i + 1) % n].narrow(dim, 0, width)      # (i+1)'s first
            return torch.cat([lo, x, hi], dim=dim)
        return finish
    if x.is_cuda and dist.get_backend(ax.group) == "gloo":
        raise RuntimeError(
            "a ppermute-mode halo exchange of CUDA tensors needs send/recv "
            "of device tensors, which the gloo backend lacks; use NCCL or "
            "halo_mode='allgather'")
    lo = torch.empty_like(last)
    hi = torch.empty_like(first)
    # my first layer is (i-1)'s hi ghost, my last (i+1)'s lo ghost; the
    # tags (and, for NCCL, the order) pair the messages when i-1 == i+1
    ops = [dist.P2POp(dist.isend, first.contiguous(), ax.peer(-1), ax.group,
                      tag=0),
           dist.P2POp(dist.isend, last.contiguous(), ax.peer(+1), ax.group,
                      tag=1),
           dist.P2POp(dist.irecv, hi, ax.peer(+1), ax.group, tag=0),
           dist.P2POp(dist.irecv, lo, ax.peer(-1), ax.group, tag=1)]
    works = dist.batch_isend_irecv(ops)

    def finish():
        for w in works:
            w.wait()
        return torch.cat([lo, x, hi], dim=dim)
    return finish


def exchange_axis(x: torch.Tensor, dim: int, ax: HaloAxis | None,
                  width: int = 1, allgather: bool = False) -> torch.Tensor:
    """Extend ``x`` with ``width`` ghost layers on both sides of ``dim``;
    ``ax`` None (or of size 1) is the periodic wrap of the local block."""
    return _start_axis(x, dim, ax, width, allgather)()


class PendingHalo:
    """An exchange in flight: :meth:`wait` returns its result.
    ``communicates`` is False when no rank other than this one takes part
    (the result is then ready)."""

    def __init__(self, finish: Callable, communicates: bool):
        self._finish = finish
        self.communicates = communicates

    def wait(self):
        return self._finish()


def exchange_halo(x: torch.Tensor, axes, dims=(0, 1, 2), width: int = 1,
                  tag: str | None = None, allgather: bool = False,
                  async_op: bool = False):
    """Extend a (cx, cy, cz, ...) local block with ghosts on all 3 dims.

    ``async_op`` returns a :class:`PendingHalo`: the first communicating
    axis's messages are issued before it returns and the axes after it run
    in ``wait()`` - the caller computes what needs no ghost in between."""
    with _span(tag):
        if tag is not None:
            record(tag, _message_bytes(x, dims, axes, width, allgather))
        todo = list(zip(dims, axes))
        while todo and not _communicates(todo[0][1]):
            d, ax = todo.pop(0)
            x = exchange_axis(x, d, ax, width)
        if not todo:
            return PendingHalo(lambda: x, False) if async_op else x
        d, ax = todo.pop(0)
        pending = _start_axis(x, d, ax, width, allgather)

        def finish():
            y = pending()
            for d2, ax2 in todo:
                y = exchange_axis(y, d2, ax2, width, allgather)
            return y

        if not async_op:
            return finish()

    def wait():
        with _span(tag):
            return finish()

    return PendingHalo(wait, True)


def _span(tag: str | None):
    """The ``repro.halo.<tag>`` range of a tagged exchange or fold."""
    return (annotate(f"repro.halo.{tag}") if tag is not None
            else contextlib.nullcontext())


def local_wrap(x: torch.Tensor, dims=(0, 1, 2), width: int = 1
               ) -> torch.Tensor:
    """Halo-extend using only the local block (periodic self-wrap).  Ghosts
    are wrong wherever an axis is sharded, but interior cells never read a
    ghost slot, so interior evaluation from it is exact and needs no
    message (:mod:`repro_torch.parallel.overlap`)."""
    for d in dims:
        x = exchange_axis(x, d, None, width)
    return x


def _pack(fields: Mapping[str, torch.Tensor], lead: int):
    """One float buffer of every field over the shared ``lead`` block dims;
    returns (buffer, layout)."""
    arrs = list(fields.values())
    base = arrs[0].shape[:lead]
    floats = [a.dtype for a in arrs if a.is_floating_point()]
    fdtype = floats[0] if floats else torch.float32
    for dt in floats[1:]:
        fdtype = torch.promote_types(fdtype, dt)
    parts, layout = [], []
    for name, a in fields.items():
        if a.shape[:lead] != base:
            raise ValueError(f"{name}: block {tuple(a.shape[:lead])} != "
                             f"{tuple(base)}")
        flat = a.reshape(*base, -1).to(fdtype)
        layout.append((name, flat.shape[-1], a.shape[lead:], a.dtype))
        parts.append(flat)
    buf = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return buf, layout


def _unpack(buf: torch.Tensor, layout, lead: int) -> dict:
    out, off = {}, 0
    for name, w, tail, dt in layout:
        part = buf[..., off:off + w]
        off += w
        if not dt.is_floating_point:
            part = torch.round(part)
        out[name] = part.reshape(*buf.shape[:lead], *tail).to(dt)
    return out


def cell_dims(lead: int = 0) -> tuple:
    """The three cell dims of a block with ``lead`` leading batch dims (a
    leading replica axis: ``lead = 1``)."""
    return tuple(d + lead for d in (0, 1, 2))


def exchange_halo_multi(fields: Mapping[str, torch.Tensor], axes,
                        width: int = 1, tag: str = "halo",
                        allgather: bool = False, async_op: bool = False,
                        lead: int = 0):
    """Fused multi-field exchange: ONE buffer, one message round per
    sharded axis, however many fields ride along.  Fields share the leading
    (cx, cy, cz, K) block - after ``lead`` batch dims, e.g. (R, cx, cy, cz,
    K) with a leading replica axis, so every local replica rides the same
    message; integer and bool fields ride the float payload (exact below
    the mantissa bound) and are rounded back.  ``async_op`` as in
    :func:`exchange_halo`."""
    buf, layout = _pack(fields, 4 + lead)
    ext = exchange_halo(buf, axes, dims=cell_dims(lead), width=width,
                        tag=tag, allgather=allgather, async_op=async_op)
    if not async_op:
        return _unpack(ext, layout, 4 + lead)
    return PendingHalo(lambda: _unpack(ext.wait(), layout, 4 + lead),
                       ext.communicates)


# ---------------------------------------------------------------------------
# adjoint exchange (ghost fold-back)
# ---------------------------------------------------------------------------

def fold_axis(x: torch.Tensor, dim: int, ax: HaloAxis | None,
              width: int = 1, allgather: bool = False) -> torch.Tensor:
    """Transpose of :func:`exchange_axis`: add the ghost layers of ``dim``
    onto the layers they were copied from and drop them."""
    w = width
    n_d = x.shape[dim]
    g_lo, g_hi = x.narrow(dim, 0, w), x.narrow(dim, n_d - w, w)
    core = x.narrow(dim, w, n_d - 2 * w).clone()
    if not _communicates(ax):
        add_last, add_first = g_lo, g_hi          # local wrap adjoint
    elif allgather:
        import torch.distributed as dist
        n, i = ax.size, ax.index
        layers = torch.cat([g_lo, g_hi], dim=dim).contiguous()
        got = [torch.empty_like(layers) for _ in range(n)]
        dist.all_gather(got, layers, group=ax.group)
        # (i+1)'s lo-ghost contributions land on my last layer, (i-1)'s
        # hi-ghost contributions on my first
        add_last = got[(i + 1) % n].narrow(dim, 0, w)
        add_first = got[(i - 1) % n].narrow(dim, w, w)
    else:
        import torch.distributed as dist
        if x.is_cuda and dist.get_backend(ax.group) == "gloo":
            raise RuntimeError(
                "a ppermute-mode halo fold of CUDA tensors needs send/recv "
                "of device tensors, which the gloo backend lacks; use NCCL "
                "or halo_mode='allgather'")
        add_last = torch.empty_like(g_lo)
        add_first = torch.empty_like(g_hi)
        ops = [dist.P2POp(dist.isend, g_lo.contiguous(), ax.peer(-1),
                          ax.group, tag=0),
               dist.P2POp(dist.isend, g_hi.contiguous(), ax.peer(+1),
                          ax.group, tag=1),
               dist.P2POp(dist.irecv, add_last, ax.peer(+1), ax.group,
                          tag=0),
               dist.P2POp(dist.irecv, add_first, ax.peer(-1), ax.group,
                          tag=1)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    c = core.shape[dim]
    core.narrow(dim, 0, w).add_(add_first)
    core.narrow(dim, c - w, w).add_(add_last)
    return core


def fold_halo(x: torch.Tensor, axes, dims=(0, 1, 2), width: int = 1,
              tag: str | None = None, allgather: bool = False
              ) -> torch.Tensor:
    """Fold a halo-extended block's ghost contributions back to their
    owners, returning the core (cx, cy, cz, ...) block; axes fold in the
    reverse of the exchange order, so edge and corner contributions travel
    the way their ghosts came."""
    with _span(tag):
        if tag is not None:
            record(tag, _message_bytes(x, dims, axes, width, allgather))
        for d, ax in reversed(list(zip(dims, axes))):
            x = fold_axis(x, d, ax, width, allgather)
        return x


def fold_halo_multi(fields: Mapping[str, torch.Tensor], axes,
                    width: int = 1, tag: str = "adjoint",
                    allgather: bool = False, lead: int = 0) -> dict:
    """Fused multi-field fold: one buffer, one message round per sharded
    axis (the adjoint mirror of :func:`exchange_halo_multi`, ``lead`` as
    there)."""
    buf, layout = _pack(fields, 4 + lead)
    return _unpack(fold_halo(buf, axes, dims=cell_dims(lead), width=width,
                             tag=tag, allgather=allgather), layout, 4 + lead)
