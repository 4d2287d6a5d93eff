"""Fault-tolerant checkpointing (port of ``repro.ckpt.checkpoint``; the
on-disk format is the port's own).

Layout: ``<dir>/step_<N>/``
  ``leaf_<i>.npy``   one file per leaf, copied to the host
  ``manifest.json``  step, the leaves' paths, shapes and dtypes - written
                     LAST, so a directory without it is an unfinished write

* atomic commit: leaves and manifest go into ``step_<N>.tmp``, which is
  renamed into place; :func:`latest_step` sees only directories with a
  manifest;
* async save: the device -> host copy happens on the caller's thread (so
  the caller may go on mutating its tensors), file IO in a worker thread.
  The returned :class:`SaveHandle` is joinable and carries the write's
  error; a failure nobody joined is raised by the NEXT save or load;
* crash hygiene: stale ``step_*.tmp`` directories are swept on the next
  save into the same directory (in-flight async writes are never swept);
* rollback pinning: ``pin=<step>`` exempts one step from the keep-``keep``
  GC.

Trees are nested dicts, tuples, lists and NamedTuples of tensors, numpy
arrays and Python scalars; ``None`` is structure, not a leaf.  A load
rebuilds the structure of a template tree and puts every tensor back on
its template leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf), ...]`` depth first: NamedTuple fields and dict keys
    (in order) name the path, sequence positions number it."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix or ".", tree)]
    out = []
    for k, v in items:
        out += _tree_paths(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _unflatten(like, leaves):
    """A tree shaped like ``like`` with its leaves taken from the iterator
    ``leaves`` in :func:`_tree_paths` order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(x, copy: bool) -> np.ndarray:
    """``x`` as a host array; ``copy`` makes it one the caller's later
    in-place writes cannot reach (a CPU tensor's ``numpy()`` shares its
    storage)."""
    if isinstance(x, torch.Tensor):
        arr = x.detach().cpu().numpy()
        return arr.copy() if copy and x.device.type == "cpu" else arr
    return np.array(x, copy=True) if copy else np.asarray(x)


def _like(arr: np.ndarray, ref):
    """``arr`` in the kind of the template leaf ``ref``."""
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(arr).to(ref.device)
    if isinstance(ref, (bool, int, float)) and arr.ndim == 0:
        return type(ref)(arr.item())
    return arr


# ---------------------------------------------------------------------------
# async-write bookkeeping (process-wide)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_IN_FLIGHT: set[str] = set()          # tmp paths with live async writers
_DEFERRED: list[BaseException] = []   # async failures not yet re-raised


class SaveHandle(str):
    """Path of a (possibly in-flight) checkpoint write: a ``str``, plus
    :meth:`join` (wait for the commit, re-raise its failure) and
    :attr:`error` (peek without blocking)."""

    def __new__(cls, path: str):
        self = super().__new__(cls, path)
        self._thread = None
        self._error = None
        return self

    @property
    def error(self) -> BaseException | None:
        return self._error

    @property
    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def join(self, timeout: float | None = None) -> "SaveHandle":
        """Wait for the write to commit; re-raise its failure (joining
        acknowledges it, so the next save or load does not raise it)."""
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            err = self._error
            with _LOCK:
                if err in _DEFERRED:
                    _DEFERRED.remove(err)
            raise RuntimeError(
                f"async checkpoint write to {self} failed") from err
        return self


def _raise_deferred():
    """Surface the oldest unacknowledged async-write failure."""
    with _LOCK:
        if not _DEFERRED:
            return
        err = _DEFERRED.pop(0)
    raise RuntimeError(
        "a previous async checkpoint write failed (its checkpoint was "
        "never committed - the newest on-disk step is older than the "
        "caller believes)") from err


def sweep_tmp(directory: str) -> list[str]:
    """Remove stale ``step_*.tmp`` directories left by a crash mid-write
    (live async writes are skipped); returns the paths swept."""
    if not os.path.isdir(directory):
        return []
    swept = []
    for d in os.listdir(directory):
        if not (d.startswith("step_") and d.endswith(".tmp")):
            continue
        full = os.path.join(directory, d)
        with _LOCK:
            live = full in _IN_FLIGHT
        if not live:
            shutil.rmtree(full, ignore_errors=True)
            swept.append(full)
    return swept


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}")


def save_checkpoint(directory: str, step: int, tree, *,
                    async_: bool = False, keep: int = 3,
                    pin: int | None = None) -> SaveHandle:
    """Write a checkpoint of ``tree``; returns its (joinable) path handle.

    ``async_`` moves the file IO to a worker thread (the host copy is made
    before this returns); ``pin`` exempts one step from the GC that keeps
    the newest ``keep``."""
    _raise_deferred()
    sweep_tmp(directory)
    paths = _tree_paths(tree)
    host = [_to_host(x, copy=async_) for _, x in paths]
    path = _step_dir(directory, step)
    tmp = path + ".tmp"
    handle = SaveHandle(path)

    def _write():
        os.makedirs(tmp, exist_ok=True)
        for i, arr in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        manifest = {
            "step": step,
            "n_leaves": len(host),
            "paths": [p for p, _ in paths],
            "shapes": [list(a.shape) for a in host],
            "dtypes": [str(a.dtype) for a in host],
            "time": time.time(),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)               # atomic commit
        _gc(directory, keep, pin=pin)

    if not async_:
        _write()
        return handle
    with _LOCK:
        _IN_FLIGHT.add(tmp)

    def _run():
        try:
            _write()
        except BaseException as e:   # surfaced on join or next save/load
            handle._error = e
            with _LOCK:
                _DEFERRED.append(e)
        finally:
            with _LOCK:
                _IN_FLIGHT.discard(tmp)

    handle._thread = threading.Thread(target=_run, daemon=True)
    handle._thread.start()
    return handle


def _gc(directory: str, keep: int, pin: int | None = None):
    pinned = None if pin is None else f"step_{pin:09d}"
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, "manifest.json")))
    for d in steps[:-keep] if keep > 0 else steps:
        if d != pinned:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def available_steps(directory: str) -> list[int]:
    """All COMPLETE checkpoint steps in ``directory`` (manifest present),
    ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, "manifest.json")))


def latest_step(directory: str) -> int | None:
    """Newest COMPLETE checkpoint step, or None."""
    steps = available_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, tree_like, step: int | None = None,
                    strict_shapes: bool = True):
    """Restore ``(tree, step)`` into the structure of ``tree_like`` (the
    newest complete step by default).  Raises ``ValueError`` when the
    leaves' paths (or, with ``strict_shapes``, their shapes) differ."""
    _raise_deferred()
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs = _tree_paths(tree_like)
    if manifest["paths"] != [p for p, _ in refs]:
        raise ValueError(
            f"checkpoint leaves {manifest['paths']} do not match the "
            f"template's {[p for p, _ in refs]} - incompatible trees")
    out = []
    for i, (name, ref) in enumerate(refs):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if strict_shapes and tuple(arr.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {name}: checkpoint {arr.shape} vs "
                             f"template {tuple(np.shape(ref))}")
        out.append(_like(arr, ref))
    return _unflatten(tree_like, iter(out)), step


# ---------------------------------------------------------------------------
# MD surface: chunk-boundary carry + generator snapshots for the engine
# ---------------------------------------------------------------------------

def save_md(directory: str, step: int, carry, generator, *, keep: int = 3,
            async_: bool = False, pin: int | None = None) -> SaveHandle:
    """Checkpoint an MD engine's carry and the state of its run's
    ``torch.Generator`` (None for a run that draws no noise; a sequence of
    generators, one per replica, is saved as a stack of their states).
    Restoring both at a chunk boundary reproduces the uninterrupted run
    bitwise."""
    if generator is None:
        gstate = np.zeros((0,), np.uint8)
    elif isinstance(generator, torch.Generator):
        gstate = generator.get_state().numpy()
    else:
        gstate = np.stack([g.get_state().numpy() for g in generator])
    return save_checkpoint(directory, step,
                           {"carry": carry, "generator": gstate},
                           keep=keep, async_=async_, pin=pin)


def load_md(directory: str, carry_like, *, step: int | None = None):
    """Restore ``(carry, generator_state, step)`` saved by :func:`save_md`;
    ``generator_state`` is a CPU uint8 tensor ((R, S) for a stack), or
    None."""
    tree, step = load_checkpoint(
        directory, {"carry": carry_like, "generator": np.zeros(0, np.uint8)},
        step=step, strict_shapes=False)
    for (name, ref), (_, got) in zip(_tree_paths(carry_like),
                                     _tree_paths(tree["carry"])):
        if tuple(np.shape(got)) != tuple(np.shape(ref)):
            raise ValueError(f"leaf carry.{name}: checkpoint "
                             f"{tuple(np.shape(got))} vs template "
                             f"{tuple(np.shape(ref))}")
    g = tree["generator"]
    return tree["carry"], (torch.from_numpy(g) if g.size else None), step
