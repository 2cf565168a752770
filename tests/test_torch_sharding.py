"""The port's sharding rules against the JAX package's, on the CPU.

* ``param_spec``: the reference's cases (``tests/test_dist.py``);
* every parameter of the reduced model of each ported family (dense,
  gemma2, MoE with and without a shared expert, hybrid, ssm): the port's
  spec of its unstacked tensor equals the reference's spec of the stacked
  leaf with the stacked dims dropped, and the two name sets map onto each
  other;
* ``param_sharding``, ``batch_sharding`` and ``cache_sharding``: the local
  shard shape of every tensor on a fake-backend (4, 2), (16, 16) and
  (2, 16, 16) mesh (``distribute_tensor`` under ``FakeTensorMode``) equals
  ``shard_shape`` of the reference's sharding on an abstract mesh of the
  same shape, the stacked dims dropped.
"""
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref
from repro.models import Model as RefModel
from repro_torch.configs import get_config
from repro_torch.dist import sharding
from repro_torch.dist.sharding import named_param_spec, param_spec, reference_path
from repro_torch.launch.mesh import make_custom_mesh, make_production_mesh
from repro_torch.models import Model

FAMILIES = ["qwen3-14b", "gemma2-2b", "olmoe-1b-7b", "llama4-scout-17b-a16e", "hymba-1.5b",
            "xlstm-1.3b", "seamless-m4t-large-v2", "internvl2-76b"]


# ----------------------------------------------------------------------
# the rule: the reference's cases
# ----------------------------------------------------------------------
def test_param_spec_column_parallel():
    s = param_spec("layers/attn/wq", (26, 512, 1024), ("data",), "model", 1)
    assert s == (None, ("data",), "model")


def test_param_spec_row_parallel():
    s = param_spec("layers/attn/wo", (26, 1024, 512), ("data",), "model", 1)
    assert s == (None, "model", ("data",))
    s = param_spec("layers/ffn/w_down", (26, 2048, 512), ("data",), "model", 1)
    assert s == (None, "model", ("data",))


def test_param_spec_moe_expert_parallel():
    s = param_spec("layers/ffn/w_gate", (16, 64, 512, 1024), ("data",), "model", 1)
    assert s == (None, "model", ("data",), None)


def test_param_spec_embed_and_norms():
    assert param_spec("embed", (50304, 512), ("data",), "model", 0) == ("model", None)
    assert param_spec("layers/ln1", (26, 512), ("data",), "model", 1) == (None, None)
    assert param_spec("layers/mamba/conv", (26, 4, 512), ("data",), "model", 1) == (
        None, None, None)


def test_reference_path_of_port_names():
    assert reference_path("embed") == ("embed", 0)
    assert reference_path("layers.3.attn.wq") == ("layers/attn/wq", 1)
    assert reference_path("layers.0.ffn.shared.w_up") == ("layers/ffn/shared/w_up", 1)
    assert reference_path("blocks.1.mlstm.2.wq") == ("blocks/mlstm/wq", 2)
    assert reference_path("blocks.1.mlstm_ln") == ("blocks/mlstm_ln", 1)
    with pytest.raises(ValueError):
        reference_path("layers.attn.wq")


# ----------------------------------------------------------------------
# every parameter of each family
# ----------------------------------------------------------------------
def _ref_leaves(arch):
    params = jax.eval_shape(lambda: RefModel(ref_get_config(arch).reduced()).init(
        jax.random.PRNGKey(0)))
    return {ref._path_str(p): leaf for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _norm(spec):
    """A spec with one-axis tuples as the axis, as ``PartitionSpec`` compares."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_parameter_spec_equals_reference(arch, axes):
    leaves = _ref_leaves(arch)
    port = Model(get_config(arch).reduced(), device="cpu")
    seen = set()
    for name, t in port.named_parameters():
        path, lead = reference_path(name)
        leaf = leaves[path]
        assert tuple(leaf.shape[lead:]) == tuple(t.shape), name
        want = _norm(ref.param_spec(path, leaf.shape, axes, "model", ref._layer_axis_for(path)))
        assert _norm(named_param_spec(name, t.shape, axes)) == want[lead:], name
        assert all(e is None for e in want[:lead]), name
        seen.add(path)
    assert seen == set(leaves)


# ----------------------------------------------------------------------
# placements and local shards on fake meshes
# ----------------------------------------------------------------------
@pytest.fixture
def fake_mesh():
    made = []

    def make(shape):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(shape))
        made.append(True)
        if len(shape) == 3:
            return make_production_mesh(multi_pod=True, device_type="cpu")
        return make_custom_mesh(*shape, device_type="cpu")

    yield make
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _abstract(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return AbstractMesh(tuple(shape), names)


def _local_shapes(mesh, tensors, placements):
    return {k: tuple(v.to_local().shape)
            for k, v in sharding.shard(mesh, tensors, placements).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mesh_shape", [(4, 2), (16, 16), (2, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_shards_equal_reference(fake_mesh, arch, mesh_shape):
    mesh = fake_mesh(mesh_shape)
    amesh = _abstract(mesh_shape)
    params = jax.eval_shape(lambda: RefModel(ref_get_config(arch).reduced()).init(
        jax.random.PRNGKey(0)))
    ref_shard = {ref._path_str(p): s.shard_shape(leaf.shape) for (p, leaf), s in zip(
        jax.tree_util.tree_flatten_with_path(params)[0],
        jax.tree.leaves(ref.param_sharding(amesh, params)))}
    with FakeTensorMode():
        port = dict(Model(get_config(arch).reduced(), device="cpu").named_parameters())
        got = _local_shapes(mesh, port, sharding.param_sharding(mesh, port))
    for name, shape in got.items():
        path, lead = reference_path(name)
        assert shape == tuple(ref_shard[path][lead:]), name


@pytest.mark.parametrize("batch", [32, 6])
@pytest.mark.parametrize("mesh_shape", [(4, 2), (16, 16)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["gemma2-2b", "hymba-1.5b", "xlstm-1.3b"])
def test_batch_and_cache_shards_equal_reference(fake_mesh, arch, mesh_shape, batch):
    """The decode cache (K/V (L, B, ...); an xLSTM's mLSTM states (G,
    every-1, B, ...)) and a token batch: shards on the batch dim where the
    data axes divide it, replicated otherwise."""
    mesh = fake_mesh(mesh_shape)
    amesh = _abstract(mesh_shape)
    ref_model = RefModel(ref_get_config(arch).reduced())
    ref_cache = jax.eval_shape(lambda: ref_model.init_cache(batch, 24))
    ref_cache_shard = {k: s.shard_shape(ref_leaf.shape) for (k, ref_leaf), s in zip(
        _flat(ref_cache).items(), jax.tree.leaves(ref.cache_sharding(amesh, ref_cache, batch)))}
    tokens = jax.ShapeDtypeStruct((batch, 24), jax.numpy.int32)
    ref_tok = ref.batch_sharding(amesh, {"tokens": tokens}, batch)["tokens"].shard_shape(
        tokens.shape)
    with FakeTensorMode():
        model = Model(get_config(arch).reduced(), device="cpu")
        cache = _flat(model.init_cache(batch, 24))
        got = _local_shapes(mesh, cache, _flat(sharding.cache_sharding(mesh, cache, batch)))
        tok = {"tokens": torch.empty((batch, 24), dtype=torch.int32)}
        got_tok = _local_shapes(mesh, tok, sharding.batch_sharding(mesh, tok, batch))
    assert got == {k: tuple(v) for k, v in ref_cache_shard.items()}
    assert got_tok["tokens"] == tuple(ref_tok)


def test_placements_of_joint_data_axes(fake_mesh):
    """``("pod", "data")`` on one tensor dim shards it on both mesh dims, pod
    major; a dim the mesh does not divide is replicated."""
    mesh = fake_mesh((2, 16, 16))
    assert sharding.placements(mesh, (("pod", "data"), "model")) == (Shard(0), Shard(0),
                                                                     Shard(1))
    got = sharding.param_sharding(mesh, {"layers.0.attn.wq": torch.empty(4096, 8192),
                                         "layers.0.attn.wo": torch.empty(8192, 100)})
    assert got["layers.0.attn.wq"] == (Shard(0), Shard(0), Shard(1))
    assert got["layers.0.attn.wo"] == (Replicate(), Replicate(), Shard(0))
