"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's counts.

- The launcher in a subprocess on one real cell (h2o-danube-1.8b
  ``decode_32k`` on the (16, 16) mesh of 256 fake ranks): the counterpart
  of ``tests/test_dryrun.py``'s compile test.
- Global FLOPs: on ``decode_32k`` the port's matmul FLOPs plus the decode
  kernel's (and the router kernel's, on the MoE models) equal the
  ``dot_general`` FLOPs of the JAX step's jaxpr (walked with the JAX
  ``flopcount``'s own ``_sub_jaxprs`` and ``_dot_flops``), exactly.  The
  JAX package's decode attention is XLA dots over the whole cache, its
  router one einsum; the port runs them as kernels, whose FLOPs the
  wrappers report on meta tensors.
- The bytes of a device's arguments equal those reckoned from the JAX
  package's specs of the same cell.
- Collectives: the counter's bytes against a hand count on a (2, 2) fake
  mesh, and ``--opt``'s sharded flash-decode on qwen3-32b: no all-gather of
  a layer's cache, and the merge's all-reduces as reckoned by hand.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import SHAPES as JSHAPES
from repro.configs.registry import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.launch import flopcount as jfc
from repro.models.registry import build_model as jbuild_model
from repro.training.optimizer import AdamWConfig as JAdamW
from repro.training.optimizer import init_opt_state as jinit_opt
from repro.training.train_step import make_train_step as jmake_step
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, flopcount
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
JAX_ACCUM = {"deepseek-v2-236b": 8, "phi3.5-moe-42b-a6.6b": 2,
             "llama-3.2-vision-11b": 2}


# ---------------------------------------------------------------------------
# the JAX side: the cell's step on ShapeDtypeStructs, its dot FLOPs


def jax_cell(arch, shape_name, absorb=False):
    """(fn, args) of the JAX dry run's cell, without a mesh."""
    model = jbuild_model(jget_config(arch))
    shape = JSHAPES[shape_name]
    batch = model.input_specs(shape)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    if shape.kind == "train":
        state = {"params": params,
                 "opt": jax.eval_shape(jinit_opt, params)}
        return jmake_step(model, JAdamW(),
                          accum_steps=JAX_ACCUM.get(arch, 1)), (state, batch)
    if shape.kind == "prefill":
        return (lambda p, b: model.prefill(p, b)), (params, batch)
    caches = jax.eval_shape(
        lambda: model.init_cache(shape.global_batch, shape.seq_len))
    if absorb:
        return (lambda p, c, b: model.decode(p, c, b, absorb_mla=True),
                (params, caches, batch))
    return (lambda p, c, b: model.decode(p, c, b)), (params, caches, batch)


def jax_dot_flops(fn, args):
    def walk(jaxpr):
        if hasattr(jaxpr, "jaxpr"):
            jaxpr = jaxpr.jaxpr
        total = 0
        for eqn in jaxpr.eqns:
            subs = jfc._sub_jaxprs(eqn)
            if subs:
                total += sum(walk(s) * m for s, m in subs)
            elif eqn.primitive.name == "dot_general":
                total += jfc._dot_flops(eqn)
        return total

    return walk(jax.make_jaxpr(fn)(*args))


def port_counts(arch, shape_name, absorb=False):
    """The dry run's global counts of the cell (plain meta tensors)."""
    fn, args, _ = dryrun.build_cell_fn(arch, shape_name, None, absorb)
    grad = (torch.enable_grad if dryrun.SHAPES[shape_name].kind == "train"
            else torch.no_grad)
    with grad():
        return flopcount.analyze(fn, *args)


# ---------------------------------------------------------------------------


def test_dryrun_single_cell_runs(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
         "--mesh", "single", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    rec = json.load(open(tmp_path /
                         "h2o-danube-1.8b__decode_32k__single.json"))
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["dot_flops_global"] + rec["kernel_flops_global"][
        "decode_attention"] == 576_632_913_920
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["memory"]["alias_bytes"] is None
    assert "[ok] h2o-danube-1.8b x decode_32k x single" in proc.stdout


@pytest.mark.parametrize("arch,absorb", [
    ("h2o-danube-1.8b", False), ("qwen3-4b", False),
    ("phi3.5-moe-42b-a6.6b", False), ("deepseek-v2-236b", False),
    ("deepseek-v2-236b", True)],
    ids=["danube", "qwen3-4b", "phi3.5-moe", "deepseek", "deepseek-absorb"])
def test_decode_flops_equal_jax_dot_count(arch, absorb):
    port = port_counts(arch, "decode_32k", absorb)
    want = jax_dot_flops(*jax_cell(arch, "decode_32k", absorb))
    # the JAX decode's attention and router are dots; the port's kernels
    # execute the same multiply-adds (4 hd a key and head; 2 T D E)
    kernels = port["kernel_flops"]
    assert port["dot_flops"] + kernels.get("decode_attention", 0) + \
        kernels.get("moe_routing", 0) == want, (port, want)
    assert ("moe_routing" in kernels) == (arch in ("phi3.5-moe-42b-a6.6b",
                                                    "deepseek-v2-236b"))
    if arch == "h2o-danube-1.8b":
        assert want == 576_632_913_920
    # the kernels the decode step does not run report nothing
    assert set(port["kernel_flops"]) <= {"decode_attention", "moe_routing"}


def _local_bytes(shape, spec, sizes, itemsize):
    n = 1
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry if isinstance(entry, tuple)
                                         else (entry,))
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * itemsize


def jax_argument_bytes(arch, shape_name, multi):
    """A device's bytes of the JAX dry run's cell arguments, from its own
    specs on a stand-in mesh (the decode ``pos``, a host int in the port,
    left out)."""
    shape_, axes = (((2, 16, 16), ("pod", "data", "model")) if multi
                    else ((16, 16), ("data", "model")))
    mesh = SimpleNamespace(axis_names=axes, devices=np.empty(shape_))
    sizes = dict(zip(axes, shape_))
    model = jbuild_model(jget_config(arch))
    shape = JSHAPES[shape_name]
    batch = dict(model.input_specs(shape))
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
    rules = jsh.TRAIN_RULES if shape.kind == "train" else jsh.PARAM_RULES
    trees = [(params, jsh.param_pspecs(params, mesh, rules))]
    if shape.kind == "train":
        opt = jax.eval_shape(jinit_opt, params)
        o = jsh.opt_pspecs(params, mesh)
        trees += [(opt["m"], o), (opt["v"], o),
                  (opt["step"], jax.sharding.PartitionSpec())]
    if shape.kind == "decode":
        batch.pop("pos")
        caches = jax.eval_shape(
            lambda: model.init_cache(shape.global_batch, shape.seq_len))
        trees.append((caches, jsh.cache_pspecs(caches, mesh)))
    trees.append((batch, jsh.batch_pspecs(batch, mesh)))
    total = 0
    for tree, specs in trees:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(spec_leaves)
        total += sum(_local_bytes(a.shape, tuple(s), sizes, a.dtype.itemsize)
                     for a, s in zip(leaves, spec_leaves))
    return total


@pytest.mark.parametrize("arch,shape_name,multi", [
    ("h2o-danube-1.8b", "decode_32k", False),
    ("qwen3-4b", "train_4k", False),
    ("phi3.5-moe-42b-a6.6b", "prefill_32k", True)])
def test_argument_bytes_equal_jax_specs(arch, shape_name, multi):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    try:
        mesh = dryrun.make_production_mesh(multi_pod=multi,
                                           device_type="cpu")
        _, args, specs = dryrun.build_cell_fn(arch, shape_name, mesh)
        got = dryrun._local_bytes(dryrun._distribute(list(args), list(specs),
                                                     mesh))
    finally:
        dist.destroy_process_group()
    assert got == jax_argument_bytes(arch, shape_name, multi)


def test_collective_bytes_hand_count():
    """On a (2, 2) fake mesh: a Shard(1) -> Replicate all-gather over
    ``model``, a Partial -> Replicate all-reduce and a Partial -> Shard
    reduce-scatter, and the sharded flash-decode's three all-reduces, each
    with the result-shape bytes reckoned by hand."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        x = sh.distribute(torch.empty((8, 64, 32), device="meta"),
                          (mesh, [Shard(0), Shard(1)]))
        part = DTensor.from_local(torch.empty((6, 10), device="meta"), mesh,
                                  [Replicate(), Partial()])
        with flopcount.Counter() as c:
            x.redistribute(mesh, [Shard(0), Replicate()])
            part.redistribute(mesh, [Replicate(), Replicate()])
            part.redistribute(mesh, [Replicate(), Shard(0)])
        f32 = 4
        assert c.collective_counts == {
            "all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
            "all-to-all": 0, "collective-permute": 0}
        assert c.collective_bytes["all-gather"] == 4 * 64 * 32 * f32
        assert c.collective_bytes["all-reduce"] == 6 * 10 * f32
        assert c.collective_bytes["reduce-scatter"] == 3 * 10 * f32
        # the flash-decode: B 8 over data, H 4, hd 16, S 64 over model
        q = sh.distribute(torch.empty((8, 1, 4, 16), device="meta"),
                          (mesh, sh.placements(sh.P("data"), mesh)))
        kv = (mesh, sh.placements(sh.P("data", "model"), mesh))
        k = sh.distribute(torch.empty((8, 64, 2, 16), device="meta"), kv)
        sh.set_active_mesh(mesh)
        try:
            with flopcount.Counter() as c:
                out = sh.sharded_decode_attention(q, k, k, 40)
        finally:
            sh.set_active_mesh(None)
        assert out.shape == (8, 1, 4, 16)
        assert c.collective_counts["all-reduce"] == 3
        assert c.collective_counts["all-gather"] == 0
        assert c.collective_bytes["all-reduce"] == (4 * 4 + 4 * 4
                                                   + 4 * 4 * 16) * f32
        assert c.kernel_flops == {"decode_attention": 4 * 4 * 4 * 32 * 16}
    finally:
        dist.destroy_process_group()


def test_opt_decode_merges_and_gathers_no_cache():
    """qwen3-32b ``decode_32k`` with ``--opt``'s switch: every layer merges
    its shards with the all-reduces of [B_loc, H] (twice) and [B_loc, H,
    hd] f32, and no all-gather has a layer's cache made whole (which the
    gathered decode does have)."""
    cfg = dryrun.get_config("qwen3-32b")
    L, H, K, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    b_loc, S = 128 // 16, 32768
    cache = b_loc * S * K * hd
    seen = {}
    for on in (False, True):
        layers.SHARDED_DECODE_ATTN = on
        try:
            seen[on] = dryrun.count_cell("qwen3-32b", "decode_32k", False)
        finally:
            layers.SHARDED_DECODE_ATTN = False
    shapes = {on: seen[on]["device"].collective_shapes
              for on in seen}

    def numels(on, kind):
        return [math.prod(s) for k, ss in shapes[on] if k == kind
                for s in ss]

    assert cache not in numels(True, "all-gather")
    assert numels(False, "all-gather").count(cache) == 2 * L   # k and v
    merge = [s for k, ss in shapes[True] if k == "all-reduce" for s in ss
             if s in ((b_loc, H), (b_loc, H, hd))]
    assert len(merge) == 3 * L
    assert sum(4 * math.prod(s) for s in merge) == L * 4 * (
        2 * b_loc * H + b_loc * H * hd)
    # the global counts do not depend on the switch
    assert seen[True]["global"] == seen[False]["global"]
