"""The port's sharding tables against the JAX package's, equal, not close.

For all ten architectures (full configs: the tables are pure arithmetic on
their sizes) on the two production meshes, stand-ins with the meshes' axis
sizes as in tests/test_sharding_and_schema.py, and the four input shapes:
``make_rules`` (global batch 1, 16 and 256, and each shape's), ``spec_for``
over every parameter, ``param_specs``, ``cache_specs``,
``train_state_specs`` (ZeRO-1), ``input_specs``' shapes and dtypes,
``batch_specs``, ``ideal_bytes`` and ``applicable``.  Then the DTensor side
of ``sharding``: placements, ``constrain`` outside a mesh, local offsets.
"""
import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import applicable as jax_applicable
from repro.models import lm as jax_lm
from repro.models.schema import Param as JaxParam
from repro.models.schema import model_schema as jax_model_schema
from repro.optim import train_state_specs as jax_train_state_specs
from repro.sharding import make_rules as jax_make_rules
from repro.sharding import spec_for as jax_spec_for
from repro.train import batch_specs as jax_batch_specs
from repro.train import input_specs as jax_input_specs
from repro.train.steps import ideal_bytes as jax_ideal_bytes
from repro_torch import sharding
from repro_torch.configs import ARCHS, SHAPES, applicable, get_shape
from repro_torch.models import lm
from repro_torch.models.schema import Param, map_schema, model_schema
from repro_torch.optim import train_state_specs
from repro_torch.sharding import constrain, make_rules, placements_for, spec_for
from repro_torch.train import batch_specs, ideal_bytes, input_specs
from repro_torch.tree import is_spec, leaves, paths


class FakeMesh:
    """Just enough of a Mesh for make_rules() and _zero1()."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "pod16x16": FakeMesh({"data": 16, "model": 16}),
    "pod2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
IS_P = lambda x: isinstance(x, P)  # noqa: E731


def _jax_specs(tree):
    """(paths, specs as tuples) of a JAX spec tree, in jax's order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=IS_P)
    return ([jax.tree_util.keystr(p) for p, _ in flat], [tuple(s) for _, s in flat])


def _port_specs(tree):
    return leaves(tree, is_spec)


def _keys(jax_paths):
    """jax's "['a'][0]['b']" paths as the port's "a/0/b"."""
    return [p.replace("][", "/").strip("[]").replace("'", "") for p in jax_paths]


def test_the_registries_and_shapes_agree():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert {k: (s.seq_len, s.global_batch, s.kind) for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in JAX_SHAPES.items()}
    assert get_shape("train_4k") == SHAPES["train_4k"]
    with pytest.raises(KeyError, match="unknown shape"):
        get_shape("train_8k")


@pytest.mark.parametrize("global_batch", [None, 1, 16, 256])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_equal_the_reference(arch, mesh_name, global_batch):
    mesh = MESHES[mesh_name]
    for seq_shard in (False, True):
        assert make_rules(ARCHS[arch], mesh, seq_shard=seq_shard, global_batch=global_batch) \
            == jax_make_rules(JAX_ARCHS[arch], mesh, seq_shard=seq_shard,
                              global_batch=global_batch)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_tables_equal_the_reference(arch, mesh_name, shape):
    """Every table of one (arch, mesh, shape) cell, as the reference builds it."""
    cfg, jcfg, mesh = ARCHS[arch], JAX_ARCHS[arch], MESHES[mesh_name]
    sh, jsh = SHAPES[shape], JAX_SHAPES[shape]
    rules = make_rules(cfg, mesh, global_batch=sh.global_batch)
    jrules = jax_make_rules(jcfg, mesh, global_batch=jsh.global_batch)
    assert rules == jrules

    # spec_for over every parameter of the schema
    params = leaves(map_schema(model_schema(cfg), lambda p: p), lambda x: isinstance(x, Param))
    jparams = jax.tree.leaves(jax_model_schema(jcfg), is_leaf=lambda x: isinstance(x, JaxParam))
    assert [(p.shape, p.axes) for p in params] == [(p.shape, p.axes) for p in jparams]
    assert [spec_for(p.axes, rules) for p in params] == \
        [tuple(jax_spec_for(p.axes, jrules)) for p in jparams]

    # param_specs, with their paths
    jpaths, jspecs = _jax_specs(jax_lm.param_specs(jcfg, jrules))
    pspecs = lm.param_specs(cfg, rules)
    assert _port_specs(pspecs) == jspecs
    assert paths(map_schema(model_schema(cfg), lambda p: 0)) == _keys(jpaths)

    # train_state_specs: the params' own, ZeRO-1's for master, mu and nu
    jstate = jax_train_state_specs(jax_lm.param_specs(jcfg, jrules),
                                   jax_lm.abstract_params(jcfg), mesh, jrules)
    state = train_state_specs(pspecs, lm.abstract_params(cfg), mesh, rules)
    assert _port_specs(state) == _jax_specs(jstate)[1]

    # cache_specs at the shape's batch and length
    B, S = sh.global_batch, sh.seq_len
    if cfg.has_decoder:
        assert _port_specs(lm.cache_specs(cfg, B, S, rules)) == \
            _jax_specs(jax_lm.cache_specs(jcfg, B, S, jrules))[1]
        jlayers = jax.tree.leaves(jax_lm.abstract_cache(jcfg, B, S)["layers"])
        assert [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for t in leaves(lm.abstract_cache(cfg, B, S))] == \
            [(tuple(a.shape), str(a.dtype)) for a in jlayers]

    # input_specs' shapes and dtypes, batch_specs
    batch, jbatch = input_specs(cfg, sh), jax_input_specs(jcfg, jsh)
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        assert tuple(batch[k].shape) == tuple(jbatch[k].shape)
        assert str(batch[k].dtype).removeprefix("torch.") == str(jbatch[k].dtype)
        assert batch[k].device.type == "meta"
    assert batch_specs(cfg, sh, rules) == {
        k: tuple(v) for k, v in jax_batch_specs(jcfg, jsh, jrules).items()}

    # ideal_bytes and applicable
    n = 512 if mesh_name == "pod2x16x16" else 256
    assert ideal_bytes(cfg, sh, n_chips=n, tp=16) == jax_ideal_bytes(jcfg, jsh, n_chips=n, tp=16)
    assert applicable(cfg, sh) == jax_applicable(jcfg, jsh)


# --- the DTensor side --------------------------------------------------------

@pytest.fixture
def fake_meshes():
    """A (2, 2), a (2, 2, 2) and a (1, 2) CPU mesh over a fake group of 8
    ranks (this process rank 0), destroyed on the way out: a worker runs
    many files."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield {"2d": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                mesh_dim_names=("data", "model")),
               "3d": DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                                mesh_dim_names=("pod", "data", "model")),
               "1x2": DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                                 mesh_dim_names=("data", "model"))}
    finally:
        dist.destroy_process_group()


def test_placements_split_a_dim_over_each_mesh_axis_it_names(fake_meshes):
    mesh = fake_meshes["3d"]
    assert placements_for((("pod", "data"), None, "model"), mesh, 3) == (
        Shard(0), Shard(0), Shard(2))
    assert placements_for((), mesh, 2) == (Replicate(),) * 3
    assert placements_for(("data",), mesh, 4) == (Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="uses mesh axis 'model' twice"):
        placements_for(("model", "model"), mesh, 2)
    with pytest.raises(ValueError, match="more entries"):
        placements_for(("data", None, "model"), mesh, 2)
    # a mesh dim of size 1 splits nothing: replicated
    assert placements_for(("data", "model"), fake_meshes["1x2"], 2) == (Replicate(), Shard(1))


def test_constrain_is_a_no_op_outside_a_mesh_and_on_plain_tensors(fake_meshes):
    x = torch.randn(4, 6)
    assert constrain(x, "batch", "embed") is x
    mesh = fake_meshes["2d"]
    rules = make_rules(ARCHS["qwen3-1.7b"].reduced(), mesh)
    with sharding.use_mesh_rules(mesh, rules):
        assert sharding.current() == (mesh, rules)
        assert constrain(x, "batch", "embed") is x
    assert sharding.current() is None


def test_constrain_redistributes_a_dtensor_and_offsets_follow_chunk(fake_meshes):
    from torch.distributed.tensor import distribute_tensor
    mesh = fake_meshes["2d"]
    rules = make_rules(ARCHS["qwen3-1.7b"].reduced(), mesh)
    x = distribute_tensor(torch.arange(40.0).reshape(10, 4), mesh, (Replicate(), Replicate()))
    with sharding.use_mesh_rules(mesh, rules):
        y = constrain(x, "batch", "vocab")  # batch over data, the reduced vocab 256 over model
        assert y.placements == (Shard(0), Shard(1))
        assert constrain(y, "batch", "vocab") is y
        assert sharding.local_offset(y, 0) == 0 and sharding.local_offset(y, 1) == 0
        assert tuple(y.to_local().shape) == (5, 2)  # rank 0's shard; a fake group sends nothing
