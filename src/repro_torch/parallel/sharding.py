"""Logical-axis sharding rules for the LM zoo (port of
``repro.parallel.sharding``).

Parameters and activations are annotated with *logical* axes; this module
resolves them against the mesh in use (single-pod (data, model) or
multi-pod (pod, data, model)), dropping mesh dimensions that do not divide
the tensor dimension (e.g. kv_heads=4 stays replicated under model=16,
Megatron-style).

  batch   -> (pod, data)     data parallel
  vocab   -> model           embedding / lm_head tensor parallel
  heads   -> model           attention-head TP
  ffn     -> model           MLP TP
  experts -> (data, model) when the expert count covers both, else model
  seq     -> model           sequence/context parallel (long prefill)
  embed   -> None            replicated (ZeRO handled by optimizer sharding)

A resolved spec is a tuple with one entry per tensor dimension: ``None``,
a mesh-dimension name, or a tuple of names (the first the outer one), as
the reference's ``PartitionSpec``.  :func:`placements` turns it into the
DTensor placements of a ``DeviceMesh`` (``Shard(d)`` on every mesh
dimension that splits tensor dimension d, ``Replicate()`` elsewhere), which
is how the port stands for GSPMD: a parameter leaf is a DTensor placed by
:func:`param_shardings`, its AdamW moments by :func:`opt_shardings`, and
:func:`shard` is the activation constraint (a redistribute, where the
reference has ``with_sharding_constraint``).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` or anything with a ``shape``
dict and ``axis_names`` (the tests' fake mesh).
"""
from __future__ import annotations

import contextlib
import math

LOGICAL = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("data", "model"),
    "experts_1d": ("model",),
    "seq": ("model",),
    "embed": (),
    "layers": (),
    None: (),
}

# FSDP mode: every weight sharded on its EMBED (d_model) dim over the
# model axis; activations stay batch-sharded over (pod, data).
LOGICAL_FSDP = {
    **LOGICAL,
    "embed": ("model",),
    "vocab": (),
    "heads": (),
    "kv_heads": (),
    "ffn": (),
    "seq": (),
}

# Pure-DP mode: params replicated, batch over every mesh axis, one
# gradient all-reduce per step.
LOGICAL_DP = {
    **LOGICAL,
    "batch": ("pod", "data", "model"),
    "vocab": (),
    "heads": (),
    "kv_heads": (),
    "ffn": (),
    "seq": (),
}

RULESETS = {"tp": LOGICAL, "fsdp": LOGICAL_FSDP, "dp": LOGICAL_DP}


def mesh_dims(mesh) -> dict:
    """{dimension name: size} of a DeviceMesh or a fake mesh."""
    if hasattr(mesh, "mesh_dim_names"):
        return {n: int(s) for n, s in zip(mesh.mesh_dim_names,
                                          mesh.mesh.shape)}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axes_in_mesh(shape: dict, names: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(a for a in names if a in shape)


def resolve_spec(mesh, logical: tuple, shape: tuple[int, ...],
                 mode: str = "tp") -> tuple:
    """Map logical axes -> a spec tuple, dropping non-dividing axes (then
    trying the suffixes of the axes, e.g. experts over model only)."""
    rules = RULESETS[mode]
    sizes = mesh_dims(mesh)
    parts = []
    for dim, name in zip(shape, logical):
        axes = _axes_in_mesh(sizes, rules.get(name, ()))
        total = math.prod(sizes[a] for a in axes)
        if axes and dim % total == 0 and dim >= total:
            parts.append(axes if len(axes) > 1 else axes[0])
            continue
        ok = None
        for cut in range(len(axes) - 1, 0, -1):
            t = math.prod(sizes[a] for a in axes[-cut:])
            if dim % t == 0 and dim >= t:
                ok = axes[-cut:] if cut > 1 else axes[-1]
                break
        parts.append(ok)
    return tuple(parts)


def placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on ``mesh``'s dimensions.  A tuple
    entry shards one tensor dimension over several mesh dimensions, the
    first the outer one; it must follow the mesh's dimension order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, s in enumerate(spec):
        if s is None:
            continue
        axes = s if isinstance(s, tuple) else (s,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{axes} does not follow the mesh order "
                             f"{tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


# ---------------------------------------------------------------------------
# the active mesh and the activation constraint
# ---------------------------------------------------------------------------

_ACTIVE = {"mesh": None, "mode": "tp"}


def set_mode(mode: str):
    """Set the ruleset used by activation :func:`shard` constraints."""
    if mode not in RULESETS:
        raise ValueError(f"unknown sharding mode {mode!r}")
    _ACTIVE["mode"] = mode


def current_mesh():
    """The mesh of the enclosing :func:`use_mesh`, or None."""
    return _ACTIVE["mesh"]


@contextlib.contextmanager
def use_mesh(mesh, mode: str | None = None):
    """Make ``mesh`` (and ``mode``) the active ones inside the block, as
    the reference's ``jax.set_mesh``; plain tensors entering a DTensor op
    count as replicated there (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    if mode is not None:
        set_mode(mode)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.update(prev)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x, *logical):
    """Activation sharding constraint: ``x`` redistributed to the resolved
    placement; a no-op on a plain tensor or with no mesh."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_spec(mesh, logical, tuple(x.shape), _ACTIVE["mode"])
    return redistribute(x, placements(mesh, spec))


def redistribute(x, want):
    """DTensor ``x`` at placements ``want`` (itself when it is there)."""
    if list(x.placements) == list(want):
        return x
    return x.redistribute(x.device_mesh, list(want))


def keep_shards(x, dims=()) -> list:
    """The placements of DTensor ``x`` with every mesh dimension that does
    not shard one of tensor dimensions ``dims`` made ``Replicate()``
    (a pending ``Partial`` sum among them)."""
    from torch.distributed.tensor import Replicate, Shard
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]


def grad_partial(pl, body_splits) -> list:
    """Gradient placements of an input that enters a ``local_map`` body at
    placements ``pl``: ``Partial()`` on each mesh dimension where the
    input is replicated but the body's work is split (``body_splits[i]``),
    since each rank's gradient then holds only its own share."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if isinstance(p, Replicate) and split else p
            for p, split in zip(pl, body_splits)]


def mesh_coord(mesh, i: int) -> int:
    """This rank's index along mesh dimension ``i``."""
    return int(mesh.get_coordinate()[i])


def group_slice(n_loc: int, offset: int, rep: int) -> tuple[int, int]:
    """The groups (kv heads, SSM groups) that heads [offset, offset +
    n_loc) read, head i reading group i // rep: (first, count).  Raises
    unless a kernel that maps local head j to local group j // (n_loc /
    count) reads the same groups."""
    first, last = offset // rep, (offset + n_loc - 1) // rep
    cnt = last - first + 1
    if cnt > 1 and (n_loc != cnt * rep or offset % rep):
        raise ValueError(f"heads {offset}..{offset + n_loc - 1} at "
                         f"{rep} a group do not split into whole groups")
    return first, cnt


def heads_local_map(body, args, roles):
    """``body`` on each rank's heads, through ``local_map``: the port's
    ``shard_map`` around a hand-written kernel, whose wrappers launch on
    raw pointers and so see local tensors only.

    ``roles[i]`` is (kind, head dim, has batch dim) of ``args[i]``: kind
    ``"h"`` splits like the heads of ``args[0]`` (q, or the SSM's x),
    ``"g"`` holds the groups those heads read (kv heads, B / C): split
    too where they divide, else whole and sliced in the body to the
    rank's heads (:func:`group_slice`); ``"b"`` has no head dimension
    (a decode cache's slot positions) and splits by batch only.
    ``args[0]`` keeps its batch and head sharding (anything else is
    gathered first); the other arguments follow it.  An input that is
    whole on a mesh dimension that splits the body's work gets its
    gradient back as a ``Partial`` sum.  Returns one DTensor, placed like
    ``args[0]``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x = args[0]
    mesh = x.device_mesh
    hx = roles[0][1]
    xp = keep_shards(x, (0, hx))
    batch = [isinstance(p, Shard) and p.dim == 0 for p in xp]
    heads = [isinstance(p, Shard) and p.dim == hx for p in xp]
    splits = [a or b for a, b in zip(batch, heads)]
    sizes = list(mesh.mesh.shape)
    in_pl, grad_pl = [], []
    for a, (kind, hd, has_b) in zip(args, roles):
        pl = []
        for i in range(len(sizes)):
            if batch[i] and has_b:
                pl.append(Shard(0))
            elif heads[i] and kind != "b" and (
                    kind == "h" or a.shape[hd] % sizes[i] == 0):
                pl.append(Shard(hd))
            else:
                pl.append(Replicate())
        in_pl.append(pl)
        grad_pl.append(grad_partial(pl, splits))
    hidx = [i for i in range(len(sizes)) if heads[i]]
    n_head_shards = math.prod(sizes[i] for i in hidx)
    lin = 0
    for i in hidx:
        lin = lin * sizes[i] + mesh_coord(mesh, i)
    n_loc = x.shape[hx] // n_head_shards
    offset = lin * n_loc

    def local(*locs):
        locs = list(locs)
        for j, ((kind, hd, _), pl) in enumerate(zip(roles, in_pl)):
            if kind == "g" and hidx and isinstance(pl[hidx[0]], Replicate):
                rep = x.shape[hx] // args[j].shape[hd]
                first, cnt = group_slice(n_loc, offset, rep)
                locs[j] = locs[j].narrow(hd, first, cnt)
        return body(*locs)

    return local_map(local, out_placements=xp, in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

# name(-suffix) -> logical axes for parameter trees. Matched on the last
# path components; first match wins. Leading stacked-layer dims are handled
# by left-padding with "layers".
PARAM_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("embed",), ("vocab", "embed")),
    (("lm_head",), ("embed", "vocab")),
    (("attn", "wq"), ("embed", "heads", None)),
    (("attn", "wk"), ("embed", "kv_heads", None)),
    (("attn", "wv"), ("embed", "kv_heads", None)),
    (("attn", "wo"), ("heads", None, "embed")),
    (("attn", "bq"), ("heads", None)),
    (("attn", "bk"), ("kv_heads", None)),
    (("attn", "bv"), ("kv_heads", None)),
    # MLA
    (("attn", "wq_a"), ("embed", None)),
    (("attn", "wq_b"), (None, "heads", None)),
    (("attn", "wkv_a"), ("embed", None)),
    (("attn", "wk_b"), (None, "heads", None)),
    (("attn", "wv_b"), (None, "heads", None)),
    # dense MLP
    (("mlp", "wi"), ("embed", "ffn")),
    (("mlp", "wg"), ("embed", "ffn")),
    (("mlp", "wo"), ("ffn", "embed")),
    # MoE
    (("moe", "router"), ("embed", "experts_1d")),
    (("moe", "wi"), ("experts", "embed", None)),
    (("moe", "wg"), ("experts", "embed", None)),
    (("moe", "wo"), ("experts", None, "embed")),
    (("moe", "sh_wi"), ("embed", "ffn")),
    (("moe", "sh_wg"), ("embed", "ffn")),
    (("moe", "sh_wo"), ("ffn", "embed")),
    # Mamba2
    (("ssm", "in_proj"), ("embed", "ffn")),
    (("ssm", "out_proj"), ("ffn", "embed")),
    (("ssm", "conv_w"), (None, "ffn")),
    (("ssm", "conv_b"), ("ffn",)),
    (("ssm", "norm_w"), ("ffn",)),
]


def param_pspec(path_names: tuple[str, ...], ndim: int) -> tuple:
    """The logical axes of the leaf at ``path_names`` (its dict keys)."""
    for suffix, logical in PARAM_RULES:
        if len(path_names) >= len(suffix) and \
                tuple(path_names[-len(suffix):]) == suffix:
            pad = ndim - len(logical)
            return ("layers",) * pad + logical if pad >= 0 else logical[:ndim]
    return (None,) * ndim


def _map_with_path(fn, tree, path=()):
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def tree_leaves_of(params, tree) -> list:
    """The entries of ``tree`` (a dict shaped like ``params`` whose leaves
    are specs or placements) in ``utils.tree.tree_leaves`` order of
    ``params`` (sorted keys)."""
    out = []
    for k in sorted(params):
        if isinstance(params[k], dict):
            out += tree_leaves_of(params[k], tree[k])
        else:
            out.append(tree[k])
    return out


def param_pspecs(mesh, params, mode: str = "tp") -> dict:
    """The resolved spec tuple of every leaf of ``params`` (nested dicts
    of tensors, meta ones included)."""
    return _map_with_path(lambda path, leaf: resolve_spec(
        mesh, param_pspec(path, leaf.dim()), tuple(leaf.shape), mode),
        params)


def param_shardings(mesh, params, mode: str = "tp") -> dict:
    """The DTensor placements of every leaf of ``params``."""
    return _map_with_path(lambda path, spec: placements(mesh, spec),
                          param_pspecs(mesh, params, mode))


def opt_spec(mesh, path, shape, mode: str = "tp") -> tuple:
    """ZeRO-1 spec of one moment: the parameter's spec under ``mode``,
    then each spare mesh dimension (pod, then data, then model) on the
    first still-replicated tensor dimension it divides.  (The reference
    resolves the parameter's spec under the tp rules whatever the mode,
    the default here; a training step passes its own mode, so that the
    moments inherit the parameters' sharding, as the reference's
    docstring says, and the update moves no shard between ranks.)"""
    sizes = mesh_dims(mesh)
    spec = list(resolve_spec(mesh, param_pspec(path, len(shape)), shape,
                             mode))
    spec += [None] * (len(shape) - len(spec))
    used = set()
    for s in spec:
        if s is not None:
            used.update(s if isinstance(s, tuple) else (s,))
    for ax in ("pod", "data", "model"):
        if ax in used or ax not in sizes:
            continue
        n = sizes[ax]
        for d in range(len(shape)):
            if spec[d] is None and shape[d] % n == 0 and shape[d] >= n:
                spec[d] = ax
                used.add(ax)
                break
    return tuple(spec)


def opt_pspecs(mesh, params, mode: str = "tp") -> dict:
    """:func:`opt_spec` of every leaf."""
    return _map_with_path(lambda path, leaf: opt_spec(
        mesh, path, tuple(leaf.shape), mode), params)


def opt_shardings(mesh, params, mode: str = "tp") -> dict:
    """The DTensor placements of every leaf's AdamW moments (ZeRO-1:
    optimizer state never needs to be replicated across data
    parallelism)."""
    return _map_with_path(lambda path, spec: placements(mesh, spec),
                          opt_pspecs(mesh, params, mode))


def embedding_lookup(table, tokens):
    """``table[tokens]`` on DTensors through ``local_map``: each rank looks
    its rows up in its own shard of the table.  Where the vocabulary is
    split, a rank holds rows [lo, hi) and gives zeros for the rest, so the
    result is a pending sum over those mesh dimensions (Megatron's
    vocab-parallel embedding); a table split over d_model gives a result
    split the same way.  (DTensor's own rule for the backward's
    ``index_put`` fails on some torch versions.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    t_pl = keep_shards(table, (0, 1))
    k_pl = keep_shards(tokens, (0,))
    vocab = [i for i, p in enumerate(t_pl)
             if isinstance(p, Shard) and p.dim == 0]
    sizes = list(mesh.mesh.shape)
    n_v = math.prod(sizes[i] for i in vocab)
    lin = 0
    for i in vocab:
        lin = lin * sizes[i] + mesh_coord(mesh, i)
    rows = table.shape[0] // n_v
    lo = lin * rows
    out_pl = []
    for tp, kp in zip(t_pl, k_pl):
        if isinstance(tp, Shard) and tp.dim == 0:
            out_pl.append(Partial())
        elif isinstance(tp, Shard):
            out_pl.append(Shard(tokens.dim()))
        else:
            out_pl.append(kp)
    splits = [isinstance(p, Shard) for p in k_pl]

    def body(tab, tok):
        if not vocab:
            return tab[tok]
        local = tok - lo
        inside = (local >= 0) & (local < rows)
        got = tab[local.clamp(0, rows - 1)]
        return got * inside[..., None].to(got.dtype)

    return local_map(body, out_placements=out_pl,
                     in_placements=(t_pl, k_pl),
                     in_grad_placements=(grad_partial(t_pl, splits), k_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, tokens)


_STAGED = []


def stage_gloo_all_gather() -> None:
    """Stage the functional all-gather of CUDA tensors through the host
    under gloo.  On the H100's torch (2.11), gloo ranks sharing the card
    crash (SIGSEGV) in ``_c10d_functional.all_gather_into_tensor`` on CUDA
    tensors, which DTensor's Shard -> Replicate uses, while their
    all-reduce, reduce-scatter and all-to-all of CUDA tensors work.  So
    once a gloo mesh on CUDA exists, an all-gather of a CUDA tensor runs
    on a host copy and comes back to the card (gloo copies through the
    host anyway).  Idempotent; NCCL and CPU tensors are untouched."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    if _STAGED:
        return
    for name in ("all_gather_tensor", "all_gather_single"):
        orig = getattr(funcol, name, None)
        if orig is None:
            continue

        def staged(self, gather_dim, group, tag="", _orig=orig):
            if self.is_cuda and dist.get_backend() == "gloo":
                return _orig(self.cpu(), gather_dim, group, tag).to(
                    self.device)
            return _orig(self, gather_dim, group, tag)
        setattr(funcol, name, staged)
    _STAGED.append(True)
