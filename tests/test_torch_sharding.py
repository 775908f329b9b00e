"""The port's sharding rules against the JAX package's, at full config.

``repro_torch.distributed.sharding`` on torch ``DeviceMesh``es of the
production shapes, built under torch's fake process group (no
communication, 256 or 512 ranks in one process), against
``repro.distributed.sharding`` on a stand-in mesh of the same shape (its
``_mesh_sizes`` reads only ``axis_names`` and ``devices.shape``).  Params
and caches are shape-only on both sides: meta tensors from the port's
``build_model(..., device="meta")``, ``jax.eval_shape`` trees from the JAX
one.  Every spec must be equal as a tuple, leaf for leaf, and every
placement must give the local shape that its spec implies.
"""

import functools
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.distributed import sharding as jsh
from repro.models.registry import build_model as jax_build_model
from repro.training.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS, cell_applicable, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import init_opt_state

@pytest.fixture(scope="module", params=["single", "multi"])
def mesh(request):
    """The production mesh, one after the other: (16, 16) on 256 fake
    ranks, then (2, 16, 16) on 512."""
    multi = request.param == "multi"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        yield make_production_mesh(multi_pod=multi, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_make_mesh_takes_any_shape_and_axes(mesh):
    n = math.prod(mesh.shape)
    for shape, axes in (((n,), ("data",)), ((n // 4, 4), ("data", "model")),
                        (tuple(mesh.shape), mesh.mesh_dim_names)):
        m = make_mesh(shape, axes, device_type="cpu")
        assert m.mesh_dim_names == tuple(axes) and tuple(m.shape) == shape


def _stand_in(mesh):
    return SimpleNamespace(axis_names=tuple(mesh.mesh_dim_names),
                           devices=np.empty(tuple(mesh.shape)))


def _flat(tree, prefix=""):
    """{keystr: leaf} with ``jax.tree_util.keystr``'s key strings."""
    if isinstance(tree, P):
        return {prefix: tree}
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], f"{prefix}[{key!r}]").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}[{i}]").items()}
    return {} if tree is None else {prefix: tree}


def _jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(path): leaf for path, leaf in leaves}


def _same_specs(port_tree, jax_tree):
    port, ref = _flat(port_tree), _jax_flat(jax_tree)
    assert sorted(port) == sorted(ref)
    bad = {k: (port[k], tuple(ref[k])) for k in ref
           if tuple(port[k]) != tuple(ref[k])}
    assert not bad, bad
    return len(port)


def _same_shapes(port_tree, jax_tree):
    port, ref = _flat(port_tree), _jax_flat(jax_tree)
    assert sorted(port) == sorted(ref)
    for k, leaf in ref.items():
        assert tuple(port[k].shape) == tuple(leaf.shape), k
        assert str(port[k].dtype).split(".")[-1] == str(leaf.dtype), k


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(port meta params, JAX eval_shape params), both at full config."""
    port = build_model(arch, device="meta").init_params(torch.Generator())
    ref = jax.eval_shape(jax_build_model(arch).init_params,
                         jax.random.PRNGKey(0))
    return port, ref


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_specs_equal_the_jax_specs(mesh, arch):
    port, ref = _trees(arch)
    _same_shapes(port, ref)
    stand = _stand_in(mesh)
    for rules, jrules in ((sh.PARAM_RULES, jsh.PARAM_RULES),
                          (sh.TRAIN_RULES, jsh.TRAIN_RULES)):
        assert rules == jrules
        n = _same_specs(sh.param_pspecs(port, mesh, rules),
                        jsh.param_pspecs(ref, stand, jrules))
        assert n > 5
    _same_specs(sh.opt_pspecs(port, mesh), jsh.opt_pspecs(ref, stand))
    # the optimizer state's own tree: m and v have the params' leaves
    opt = init_opt_state(port)
    jopt = jax.eval_shape(jax_init_opt_state, ref)
    _same_shapes(opt, jopt)
    _same_specs(sh.opt_pspecs(opt["m"], mesh), jsh.opt_pspecs(jopt["m"],
                                                              stand))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_specs_equal_the_jax_specs(mesh, arch):
    model, jmodel = build_model(arch, device="meta"), jax_build_model(arch)
    stand = _stand_in(mesh)
    for shape in SHAPES.values():
        port, ref = model.input_specs(shape), jmodel.input_specs(shape)
        _same_shapes(port, ref)
        assert all(t.device.type == "meta" for t in _flat(port).values())
        _same_specs(sh.batch_pspecs(port, mesh), jsh.batch_pspecs(ref, stand))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_jax_specs(mesh, arch):
    model, jmodel = build_model(arch, device="meta"), jax_build_model(arch)
    stand = _stand_in(mesh)
    cells = [s for s in ("decode_32k", "long_500k")
             if cell_applicable(get_config(arch), SHAPES[s])[0]]
    assert "decode_32k" in cells
    for name in cells:
        shape = SHAPES[name]
        port = model.init_cache(shape.global_batch, shape.seq_len)
        ref = jax.eval_shape(
            lambda: jmodel.init_cache(shape.global_batch, shape.seq_len))
        _same_shapes(port, ref)
        _same_specs(sh.cache_pspecs(port, mesh), jsh.cache_pspecs(ref, stand))


def _local_shape(shape, spec, mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            axes = entry if isinstance(entry, tuple) else (entry,)
            out[d] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-v2-236b",
                                  "hymba-1.5b", "rwkv6-1.6b"])
def test_placements_give_the_local_shapes_of_the_specs(mesh, arch):
    port, _ = _trees(arch)
    model = build_model(arch, device="meta")
    cache = model.init_cache(SHAPES["decode_32k"].global_batch, 1024)
    batch = model.input_specs(SHAPES["train_4k"])
    for tree, specs in ((port, sh.param_pspecs(port, mesh, sh.TRAIN_RULES)),
                        (port, sh.opt_pspecs(port, mesh)),
                        (cache, sh.cache_pspecs(cache, mesh)),
                        (batch, sh.batch_pspecs(batch, mesh))):
        leaves, spec_of = _flat(tree), _flat(specs)
        for key, leaf in leaves.items():
            spec = spec_of[key]
            d = distribute_tensor(leaf, mesh, sh.placements(spec, mesh))
            assert tuple(d.to_local().shape) == _local_shape(
                leaf.shape, spec, mesh), (key, spec)


def test_to_shardings_and_distribute_follow_the_spec_tree(mesh):
    tree = {"a": torch.empty(32, 64, device="meta"),
            "b": [torch.empty(4, 16, device="meta"), None]}
    specs = {"a": P("data", "model"), "b": [P(None, "model"), None]}
    shardings = sh.to_shardings(specs, mesh)
    assert shardings["a"][0] is mesh and shardings["b"][1] is None
    out = sh.distribute(tree, shardings)
    assert isinstance(out["a"], DTensor) and out["b"][1] is None
    assert tuple(out["a"].to_local().shape) == (2, 4)
    assert tuple(out["b"][0].to_local().shape) == (4, 1)
    assert list(out["a"].placements) == sh.placements(specs["a"], mesh)


HAND = [
    # (mesh axes, spec, placements)
    (("data", "model"), P("model", "data"), [Shard(1), Shard(0)]),
    (("data", "model"), P(None, "model"), [Replicate(), Shard(1)]),
    (("data", "model"), P(), [Replicate(), Replicate()]),
    (("data", "model"), P("data"), [Shard(0), Replicate()]),
    (("pod", "data", "model"), P(("pod", "data")),
     [Shard(0), Shard(0), Replicate()]),
    (("pod", "data", "model"), P(("pod", "data"), None, "model"),
     [Shard(0), Shard(0), Shard(2)]),
    (("pod", "data", "model"), P("pod", "data", "model"),
     [Shard(0), Shard(1), Shard(2)]),
    (("pod", "data", "model"), P("pod", "model", None, "data"),
     [Shard(0), Shard(3), Shard(1)]),
]


@pytest.mark.parametrize("axes,spec,expected", HAND,
                         ids=[repr(h[1]) for h in HAND])
def test_placements_hand_table(axes, spec, expected):
    mesh = SimpleNamespace(mesh_dim_names=axes)
    assert sh.placements(spec, mesh) == expected


@pytest.mark.parametrize("spec", [P(("data", "pod")), P("data", "data"),
                                  P(("model", "data"))])
def test_placements_refuse_axes_out_of_mesh_order_or_named_twice(spec):
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError):
        sh.placements(spec, mesh)


# the JAX package's own cases (tests/test_dryrun.py), on a (1, 2) mesh
REFERENCE_CASES = {
    # GQA kv heads that don't divide the model axis replicate
    "kv_heads_3_replicate": (
        "param", {"groups": [{"attn": {"wq": (4, 64, 8, 16),
                                       "wk": (4, 64, 3, 16)}}]},
        {"['groups'][0]['attn']['wq']": P(None, None, "model"),
         "['groups'][0]['attn']['wk']": P()}),
    # the cache's largest divisible dim takes 'model'
    "cache_largest_divisible_dim": (
        "cache", [{"k": (4, 2, 64, 3, 16)}],
        {"[0]['k']": P(None, "data", "model")}),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_the_reference_rule_cases(case):
    small_mesh = SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 2))
    kind, shapes, expected = REFERENCE_CASES[case]
    fn = sh.param_pspecs if kind == "param" else sh.cache_pspecs

    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        if isinstance(t, list):
            return [meta(v) for v in t]
        return torch.empty(t, device="meta")

    specs = _flat(fn(meta(shapes), small_mesh))
    assert specs == expected
    stand = _stand_in(small_mesh)
    jax_tree = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s, np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    jfn = jsh.param_pspecs if kind == "param" else jsh.cache_pspecs
    assert {k: tuple(v) for k, v in _jax_flat(jfn(jax_tree, stand)).items()} \
        == {k: tuple(v) for k, v in expected.items()}


def test_the_hooks_are_the_identity_off_a_mesh_and_on_plain_tensors(mesh):
    hooks = (sh.constrain_tokens, sh.constrain_seq, sh.constrain_moe_groups,
             sh.constrain_moe_expert)
    xs = [torch.randn(4, 8, 6), torch.randn(2, 2, 4, 6),
          torch.randn(2, 2, 4, 3, 6), torch.randn(8, 6)]
    assert sh.get_active_mesh() is None
    for hook in hooks:
        for x in xs:
            assert hook(x) is x
    sh.set_active_mesh(mesh)
    try:
        for hook in hooks:
            for x in xs:
                assert hook(x) is x
    finally:
        sh.set_active_mesh(None)


def test_the_hooks_redistribute_a_dtensor_on_the_active_mesh(mesh):
    def whole(*shape):
        return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                 [Replicate()] * mesh.ndim)

    dp = sh.dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    x = whole(32, 64, 6)
    assert sh.constrain_seq(x) is x          # no active mesh
    sh.set_active_mesh(mesh)
    try:
        cases = [(sh.constrain_seq, x, P(dp, "model")),
                 (sh.constrain_seq, whole(3, 64, 6), P(None, "model")),
                 (sh.constrain_moe_groups, whole(32, 16, 4, 6), P(dp,
                                                                  "model")),
                 (sh.constrain_moe_groups, whole(32, 1, 4, 6), P(dp)),
                 (sh.constrain_moe_expert, whole(32, 2, 16, 3, 6),
                  P(dp, None, "model")),
                 (sh.constrain_moe_expert, whole(32, 2, 8, 3, 6), P(dp)),
                 (sh.constrain_tokens, whole(1024, 6),
                  P(tuple(mesh.mesh_dim_names)))]
        for hook, t, spec in cases:
            assert list(hook(t).placements) == sh.placements(spec, mesh), (
                hook.__name__, tuple(t.shape))
        # one token (decode) or a sequence that does not divide: as it is
        for t in (whole(32, 1, 6), whole(32, 7, 6)):
            assert sh.constrain_seq(t) is t
    finally:
        sh.set_active_mesh(None)


def test_the_meta_model_allocates_nothing():
    model = build_model("qwen3-32b", device="meta")
    params = model.init_params(torch.Generator())
    leaves = list(_flat(params).values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 30e9
    caches = model.init_cache(128, 32768)
    assert all(t.device.type == "meta" for t in _flat(caches).values())
