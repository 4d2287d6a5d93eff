"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's ``repro.parallel.sharding``: pure spec logic on a fake mesh,
no ranks.

The six cases of ``tests/test_sharding.py`` through the port; then, for
every leaf of the ten smoke configs' parameters at tp = 16 on the two
production meshes (16 x 16 and 2 x 16 x 16), the port's resolved spec
against the reference's, leaf by leaf, in each of the ``tp``, ``fsdp`` and
``dp`` rulesets; the ZeRO-1 moment specs' spare-axis rule by hand; the
activation constraint's no-op without a mesh.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.parallel import sharding as jsh
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.transformer import padded_vocab
from repro_torch.parallel import sharding as sh
from torch_one_thread import one_torch_thread  # noqa: F401


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _p(spec: tuple):
    """The port's spec tuple as the reference's PartitionSpec."""
    return P(*spec)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases
# ---------------------------------------------------------------------------

def test_batch_axes_resolution():
    spec = sh.resolve_spec(MESH2, ("batch", None, None), (256, 4096, 1024))
    assert _p(spec) == P(("pod", "data"), None, None)


def test_nondividing_axis_dropped():
    spec = sh.resolve_spec(MESH1, ("embed", "kv_heads", None), (1024, 4, 128))
    assert _p(spec) == P(None, None, None)
    spec = sh.resolve_spec(MESH1, ("embed", "kv_heads", None),
                           (1024, 32, 128))
    assert _p(spec) == P(None, "model", None)


def test_experts_2d_vs_1d():
    spec = sh.resolve_spec(MESH1, ("experts", None, None), (256, 7168, 2048))
    assert _p(spec) == P(("data", "model"), None, None)
    spec = sh.resolve_spec(MESH1, ("experts", None, None), (64, 2048, 1408))
    assert _p(spec) == P("model", None, None)


def test_param_rules_match_paths():
    assert sh.param_pspec(("g0", "attn", "wq"), 4) == \
        ("layers", "embed", "heads", None)
    assert sh.param_pspec(("g1", "moe", "wi"), 4) == \
        ("layers", "experts", "embed", None)
    assert sh.param_pspec(("embed",), 2) == ("vocab", "embed")
    assert sh.param_pspec(("g0", "ssm", "in_proj"), 3) == \
        ("layers", "embed", "ffn")
    assert sh.param_pspec(("whatever",), 3) == (None, None, None)


def test_batch_smaller_than_axes_replicates():
    spec = sh.resolve_spec(MESH2, ("batch",), (1,))
    assert _p(spec) == P(None)


def test_vocab_padding_multiple():
    assert padded_vocab(50280) % 256 == 0
    assert padded_vocab(50280) >= 50280
    assert padded_vocab(152064) == 152064


# ---------------------------------------------------------------------------
# every leaf of the zoo's smoke configs against the reference
# ---------------------------------------------------------------------------

def _jax_leaves(tree):
    """{"/a/b": (path names, shape)} of a JAX parameter pytree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = jsh._path_names(path)
        out["/" + "/".join(names)] = (names, tuple(leaf.shape))
    return out


def _port_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_specs(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
@pytest.mark.parametrize("mesh", [MESH1, MESH2], ids=["16x16", "2x16x16"])
def test_param_specs_equal_the_references(arch, mesh):
    """tp through both packages' ``param_pspecs``; fsdp and dp through the
    reference's ``resolve_spec`` on its ``param_pspec`` of each leaf."""
    jtree = jlm.abstract_params(jconfigs.get_smoke(arch), tp=16)
    ptree = lm.abstract_params(configs.get_smoke(arch), tp=16)
    jleaves = _jax_leaves(jtree)
    want_tp = {}
    jspecs = jax.tree_util.tree_flatten_with_path(
        jsh.param_pspecs(mesh, jtree),
        is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in jspecs:
        want_tp["/" + "/".join(jsh._path_names(path))] = spec
    for mode in ("tp", "fsdp", "dp"):
        got = _port_specs(sh.param_pspecs(mesh, ptree, mode))
        assert set(got) == set(jleaves)
        for key, (names, shape) in jleaves.items():
            want = (want_tp[key] if mode == "tp" else jsh.resolve_spec(
                mesh, jsh.param_pspec(names, len(shape)), shape, mode))
            assert _p(got[key]) == want, (mode, key, got[key], want)


# ---------------------------------------------------------------------------
# ZeRO-1 moments, placements, the constraint
# ---------------------------------------------------------------------------

def test_opt_spec_spare_axes_by_hand():
    """The moments keep the parameter's spec, then take pod, data and
    model in that order on the first still-replicated dimension each
    divides."""
    # wq (L, d, heads, hd): heads over model; pod and data look for a
    # free dimension: L = 4 takes pod (2 | 4), data (16) skips L (taken),
    # takes d = 64
    assert sh.opt_spec(MESH2, ("g0", "attn", "wq"), (4, 64, 32, 128)) == \
        ("pod", "data", "model", None)
    # the replicated final norm (d,): pod takes it; data has nowhere left
    assert sh.opt_spec(MESH2, ("final_norm", "_w"), (64,)) == ("pod",)
    # kv_heads = 4 do not take model (16), so model becomes a spare axis:
    # data on L = 32, model on d = 64
    assert sh.opt_spec(MESH1, ("g0", "attn", "wk"), (32, 64, 4, 128)) == \
        ("data", "model", None, None)
    # nothing divides: replicated
    assert sh.opt_spec(MESH1, ("final_norm", "_w"), (3,)) == (None,)
    # embed (V, d): vocab over model, data on d
    assert sh.opt_spec(MESH1, ("embed",), (512, 64)) == ("model", "data")
    # under fsdp the moments inherit the fsdp spec (d over model), then
    # data takes the first free dimension: the layers
    assert sh.opt_spec(MESH1, ("g0", "attn", "wq"), (32, 64, 32, 128),
                       "fsdp") == ("data", "model", None, None)
    assert sh.opt_spec(MESH1, ("g0", "attn", "wq"), (32, 64, 32, 128)) == \
        ("data", None, "model", None)


def test_opt_pspecs_cover_every_leaf():
    params = lm.abstract_params(configs.get_smoke("qwen2-7b"), tp=16)
    specs = _port_specs(sh.opt_pspecs(MESH2, params))
    assert set(specs) == set(_port_specs(params))
    for key, spec in specs.items():
        used = [a for s in spec if s is not None
                for a in (s if isinstance(s, tuple) else (s,))]
        assert len(used) == len(set(used)), key


class _Named:
    """Stands for a DeviceMesh in ``placements``: its dimension names."""

    def __init__(self, names):
        self.mesh_dim_names = names


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = _Named(("pod", "data", "model"))
    assert sh.placements(m, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.placements(m, (None, None)) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(m, (("model", "data"),))


def test_shard_is_a_no_op_without_a_mesh():
    x = torch.ones(2, 3)
    assert sh.current_mesh() is None
    assert sh.shard(x, "batch", None) is x
    with pytest.raises(ValueError, match="unknown sharding mode"):
        sh.set_mode("zero3")


def test_group_slice():
    """The kv heads (groups) a rank's q heads read."""
    # 4 q heads a rank, 8 a group: one group, shared by two ranks
    assert sh.group_slice(4, 4, 8) == (0, 1)
    assert sh.group_slice(4, 8, 8) == (1, 1)
    # 14 q heads a rank at 7 a group: two whole groups
    assert sh.group_slice(14, 14, 7) == (2, 2)
    # 6 q heads a rank at 4 a group straddle groups unevenly
    with pytest.raises(ValueError, match="whole groups"):
        sh.group_slice(6, 6, 4)
