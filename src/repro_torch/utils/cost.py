"""Op-level cost model: FLOPs, bytes and live memory of what a function runs
(the counterpart of ``repro.utils.jaxpr_cost``).

PyTorch has no jaxpr to walk, so :class:`CostCounter` is a
``TorchDispatchMode`` that sees every aten op as it executes, on real or
fake tensors (``FakeTensorMode``: shapes only, nothing allocated).  Loops run,
so their trip counts are exact by construction; a backward pass is counted
op by op as autograd runs it.  The reference's categories:

* FLOPs: products exactly (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions, and what ``einsum`` lowers to) by the formulas registered in
  ``torch.utils.flop_counter``, ``mv`` and ``dot`` as 2 per matrix (vector)
  element; reductions their input size; the data
  movement of :data:`_FREE` nothing; every other op one per output element
  (the reference's elementwise class, cumulative sums included);
* ``bytes_naive``: every op's inputs plus outputs (an upper bound on device
  traffic: nothing is fused);
* ``bytes_anchor``: the same, for the :data:`_ANCHOR_BYTES` class only
  (products, index / gather / scatter, sort, top-k, cumsum, random draws),
  whose operands touch device memory whatever a compiler fuses;
* ``peak_bytes``: the peak of live bytes of the ops' outputs while counting
  (a new output adds its bytes until its tensor dies; views and in-place
  results share their base's bytes and add none); inputs made before the
  counter started are not in it.

``ops`` counts each aten op by name (``mm``, ``index``, ...), which
:func:`repro_torch.utils.collectives.count_op` reads.

DTensors (a step on a mesh): the counter declines an op on DTensors, so
DTensor's own dispatch runs it and the ops it issues on the rank's LOCAL
tensors come back to the counter, which so counts one rank's program: its
local products and elementwise work, and each collective that its
redistributions issue (``_c10d_functional`` all-reduce, all-gather,
reduce-scatter, all-to-all, and the ``c10d`` ops of an explicit
``torch.distributed`` call), counted by the reference's HLO kind in
``collectives`` with its per-rank output bytes (the reference's
output-shape proxy for the wire volume).  DTensor's own planning is not
the program: the global-shape run that derives an output's metadata and
the shard arithmetic of the redistribution planner run with counting
paused (:func:`_hook_dtensor_planning`).
"""
from __future__ import annotations

import collections
import functools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.utils.collectives import collective_kind

# data movement, comparisons and allocation: no FLOPs
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "_to_copy", "copy_", "copy", "clone", "slice", "select", "narrow", "cat",
    "stack", "split", "split_with_sizes", "unbind", "chunk",
    "constant_pad_nd", "index", "index_select", "gather", "scatter",
    "scatter_add", "index_add", "index_put", "_index_put_impl", "arange",
    "flip", "roll", "repeat", "eq", "ne", "lt", "le", "gt", "ge", "isfinite",
    "isnan", "isinf", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "fill",
    "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full",
    "zero", "scalar_tensor", "lift_fresh", "lift_fresh_copy", "detach",
    "alias", "as_strided", "diagonal", "unfold", "_local_scalar_dense",
    "masked_select", "nonzero", "masked_fill",
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
    "argmax", "argmin", "var", "std", "norm", "linalg_vector_norm",
    "logsumexp", "var_mean", "std_mean",
}

# ops whose operands and results touch device memory even after fusion
_ANCHOR_BYTES = {
    "mm", "bmm", "addmm", "baddbmm", "mv", "dot", "vdot", "convolution",
    "_convolution",
    "convolution_backward", "index", "index_select", "gather", "scatter",
    "scatter_add", "scatter_reduce", "index_add", "index_put",
    "_index_put_impl", "sort", "topk", "cumsum", "normal", "randn", "rand",
    "uniform", "bernoulli", "randint", "random", "randperm", "exponential",
    "multinomial",
}


def _name(func) -> str:
    """The aten op's base name, in-place variants folded in:
    ``aten.add_.Tensor`` -> ``add``."""
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") else name


def _tensors(xs, out: list | None = None) -> list:
    """The tensors among ``xs`` and its (nested) lists, tuples and dict
    values - what an aten op takes and returns."""
    out = [] if out is None else out
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
        elif isinstance(x, dict):
            _tensors(x.values(), out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_PAUSED = [0]       # > 0 inside DTensor's planning: nothing is counted


def _paused(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _PAUSED[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PAUSED[0] -= 1
    run.cost_paused = True
    return run


def _hook_dtensor_planning() -> None:
    """Pause every counter inside DTensor's planning, once per process:
    ``ShardingPropagator._propagate_tensor_meta_non_cached`` (the op run
    on global-shape fake tensors to derive an output's metadata) and
    ``_redistribute._gen_transform_infos_non_cached`` (the planner, whose
    shard arithmetic runs torch ops).  Where a torch version lacks one,
    it is left alone."""
    try:
        from torch.distributed.tensor import _redistribute, _sharding_prop
    except ImportError:          # a build without torch.distributed
        return
    for owner, name in ((_sharding_prop.ShardingPropagator,
                         "_propagate_tensor_meta_non_cached"),
                        (_redistribute, "_gen_transform_infos_non_cached")):
        fn = getattr(owner, name, None)
        if fn is not None and not getattr(fn, "cost_paused", False):
            setattr(owner, name, _paused(fn))


@functools.cache
def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:          # a build without torch.distributed
        return ()
    return DTensor


class CostCounter(TorchDispatchMode):
    """Count the ops run while active (a context manager)::

        with FakeTensorMode(), CostCounter() as cost:
            step(...)
        cost.cost()   # {"flops", "bytes_naive", "bytes_anchor"}
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = 0
        self.bytes_naive = 0
        self.bytes_anchor = 0
        self.ops: collections.Counter = collections.Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.coll_counts: collections.Counter = collections.Counter()
        self.coll_bytes: collections.Counter = collections.Counter()
        _hook_dtensor_planning()

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(isinstance(t, _dtensor_type()) for t in ins):
            return NotImplemented    # DTensor runs it; its local ops return
        out = func(*args, **kwargs)
        if _PAUSED[0]:
            return out
        name = _name(func)
        self.ops[name] += 1
        outs = _tensors((out,))
        kind = collective_kind(name)
        if kind is not None:     # a c10d op writes its first argument
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += sum(map(_nbytes, outs or ins[:1]))
        io = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes_naive += io
        if name in _ANCHOR_BYTES:
            self.bytes_anchor += io
        packet = func._overloadpacket
        if packet in self._registry:
            self.flops += int(self._registry[packet](*args, **kwargs,
                                                     out_val=out))
        elif name in ("mv", "dot", "vdot"):      # not in the registry
            self.flops += 2 * args[0].numel()
        elif name in _FREE:
            pass
        elif name in _REDUCTIONS:
            self.flops += sum(t.numel() for t in ins)
        else:       # the elementwise class
            self.flops += sum(t.numel() for t in outs)
        if not (func.is_view or func._schema.is_mutable):
            for t in outs:
                n = _nbytes(t)
                self.live_bytes += n
                weakref.finalize(t, self._free, n)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out

    def cost(self) -> dict:
        """The reference's triple: ``{"flops", "bytes_naive",
        "bytes_anchor"}``."""
        return {"flops": int(self.flops), "bytes_naive": int(self.bytes_naive),
                "bytes_anchor": int(self.bytes_anchor)}

    def record(self) -> dict:
        """The triple, the peak of live output bytes, the op counts and the
        collectives (``{"counts", "bytes"}`` by HLO kind, the halo
        ledger's snapshot shape)."""
        return {**self.cost(), "peak_bytes": int(self.peak_bytes),
                "ops": dict(self.ops),
                "collectives": {"counts": dict(self.coll_counts),
                                "bytes": dict(self.coll_bytes)}}


def lowered_cost(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and return
    its :meth:`~CostCounter.cost` triple (the reference's ``lowered_cost``
    of the traced function)."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost()
