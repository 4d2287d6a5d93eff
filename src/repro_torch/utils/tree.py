"""Small utilities over parameter containers (port of ``repro.utils.tree``).

A container is a tensor, or a NamedTuple, dataclass, dict, list or tuple of
containers (``NEPSpinParams``, the LM parameter dicts); its leaves are the
tensors in field order, as the reference's pytree leaves.
"""
from __future__ import annotations

import dataclasses

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    """The tensors of a container, depth first in field order (dict keys
    sorted, as ``jax.tree_util`` orders them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return []


def tree_unflatten(like, leaves):
    """A container shaped like ``like`` whose tensors are ``leaves``, taken
    in :func:`tree_leaves` order (dicts rebuilt with sorted keys)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t) if f.init})
        if _is_namedtuple(t):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return t
    return build(like)


def tree_map(fn, tree):
    """``fn`` on every tensor of a container, keeping its structure (other
    leaves pass through)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tree_count(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves (declared dtype)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_cast(tree, dtype):
    """Cast every floating (or complex) leaf to ``dtype``."""
    return tree_map(lambda x: x.to(dtype) if (x.is_floating_point()
                                              or x.is_complex()) else x,
                    tree)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype),
                    tree)


def sum_squares(x) -> torch.Tensor:
    """The sum of squares of ``x`` in f32; of the whole tensor for a
    DTensor (a plain tensor, the same on every rank)."""
    s = torch.sum(torch.square(x.to(torch.float32)))
    return s.full_tensor() if hasattr(s, "full_tensor") else s


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, taken in f32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(sum_squares(x) for x in leaves))
