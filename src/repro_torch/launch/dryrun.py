# Port of repro/launch/dryrun.py: the multi-pod dry run on meta DTensors under torch's fake process group.
"""Multi-pod dry run: every (architecture x input shape) cell's step on the
production mesh, with no card and no allocation.

For every cell the step (``make_train_step``, the prefill or one decode
token against a ``seq_len``-deep cache) runs on meta tensors -- shapes and
dtypes, no values -- twice:

- on plain meta tensors, the whole global batch on one "device": the
  global FLOPs (matmuls, pointwise ops and each kernel's apart) and bytes;
- on meta DTensors laid out by the port's rules on the production mesh,
  (16, 16) ``data x model`` on 256 ranks or (2, 16, 16) ``pod x data x
  model`` on 512, under torch's fake process group (rank 0 of a group that
  communicates nothing): the collectives DTensor issues and their
  result-shape bytes on this rank, and the memory of a device.

Both runs go through ``launch.flopcount.Counter`` (the counterpart of the
JAX package's ``flopcount`` and ``hloparse``).  Each cell writes
``{arch}__{shape}__{mesh}[__tag].json`` with

  - ``flops_global``, ``dot_flops_global``, ``kernel_flops_global`` (by
    kernel), ``bytes_global``;
  - ``collective_bytes_per_device``, ``collective_counts``: the plan
    DTensor's own planner makes, as the program on a mesh runs it;
  - ``memory``: ``argument_bytes`` and ``output_bytes`` of a device (the
    local shards of the step's inputs and outputs; the train step updates
    its state in place, so its outputs are mostly its arguments' storages),
    ``temp_bytes`` (``Counter.peak_temp_bytes``: the peak of the live
    local storages the step made, beyond its arguments, on rank 0), and
    ``alias_bytes`` and ``code_bytes`` null: eager PyTorch has no compiled
    program whose buffers alias or whose code has a size, as XLA's
    ``memory_analysis`` reports them (for the same reason there is no
    ``cost`` and no ``hlo_bytes``);
  - ``model_flops``: 6 N tokens (train), 2 N tokens (prefill) or 2 N B
    (decode), N the active parameters, as ``benchmarks/roofline.py``.

The device is meta throughout: the dry run never touches CUDA.  A decode
cell's ``pos`` is the host int ``seq_len - 1``, so every position of the
cache is valid, as the JAX cell's traced ``pos`` leaves it.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch._tree import tree_leaves
from repro_torch.configs import registry as creg
from repro_torch.configs.registry import (SHAPES, all_cells, cell_applicable,
                                          get_config)
from repro_torch.distributed import sharding as sh
from repro_torch.launch import flopcount
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import build_model
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

# the largest models microbatch the global batch (the JAX dry run's table)
ACCUM = {"deepseek-v2-236b": 8, "phi3.5-moe-42b-a6.6b": 2,
         "llama-3.2-vision-11b": 2}


def build_cell_fn(arch: str, shape_name: str, mesh=None, absorb_mla=False):
    """(fn, args, in_specs) for one cell: ``fn(*args)`` is the cell's step
    on plain meta tensors ``args`` (the decode ``pos`` a host int, its spec
    None); ``in_specs`` the PartitionSpec tree of ``args`` on ``mesh``.
    With a mesh, the train step redistributes its gradients to the
    optimizer's layout (``grad_shardings``), as the JAX step constrains
    them; without one it runs unsharded."""
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    shape = SHAPES[shape_name]
    batch = model.input_specs(shape)
    params = model.init_params(torch.Generator())
    if shape.kind == "train":
        rules = sh.TRAIN_RULES
    else:
        rules = sh.PARAM_RULES
    p_spec = b_spec = None
    if mesh is not None:
        p_spec = sh.param_pspecs(params, mesh, rules)
        b_spec = sh.batch_pspecs(batch, mesh)

    if shape.kind == "train":
        state = {"params": params, "opt": init_opt_state(params)}
        grad_shardings = None
        state_spec = None
        if mesh is not None:
            o_spec = sh.opt_pspecs(params, mesh)
            state_spec = {"params": p_spec,
                          "opt": {"m": o_spec, "v": o_spec, "step": sh.P()}}
            grad_shardings = sh.to_shardings(o_spec, mesh)
        step = make_train_step(model, AdamWConfig(),
                               grad_shardings=grad_shardings,
                               accum_steps=ACCUM.get(arch, 1))
        return step, (state, batch), (state_spec, b_spec)

    if shape.kind == "prefill":
        return model.prefill, (params, batch), (p_spec, b_spec)

    # decode: one new token against a seq_len-deep cache, every slot valid
    caches = model.init_cache(shape.global_batch, shape.seq_len)
    c_spec = sh.cache_pspecs(caches, mesh) if mesh is not None else None
    batch["pos"] = shape.seq_len - 1
    if b_spec is not None:
        b_spec["pos"] = None
    if absorb_mla:
        def step(params, caches, batch):
            return model.decode(params, caches, batch, absorb_mla=True)
    else:
        step = model.decode
    return step, (params, caches, batch), (p_spec, c_spec, b_spec)


def _distribute(tree, specs, mesh):
    """``tree`` as meta DTensors by ``specs``; a leaf whose spec is None (a
    host int) stays as it is."""
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_distribute(v, s, mesh) for v, s in zip(tree, specs)]
    if tree is None or specs is None:
        return tree
    return sh.distribute(tree, (mesh, sh.placements(specs, mesh)))


def _local_bytes(tree) -> int:
    """Bytes of the distinct local storages of a tree's tensors."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        local = t.to_local() if isinstance(t, DTensor) else t
        st = local.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def _fake_group(world_size):
    """Rank 0 of a fake process group of ``world_size`` ranks: the one
    default group of this process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def count_cell(arch, shape_name, multi_pod, absorb_mla=False) -> dict:
    """The counts of one cell (see the module): the global run on plain
    meta tensors, then the per-device run on the production mesh (whose
    fake process group this call initialises and destroys)."""
    # serving runs without grad mode, as the engine does
    grad = torch.enable_grad if SHAPES[shape_name].kind == "train" \
        else torch.no_grad
    fn, args, _ = build_cell_fn(arch, shape_name, None, absorb_mla)
    with grad():
        glob = flopcount.analyze(fn, *args)
    del fn, args
    _fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        fn, args, specs = build_cell_fn(arch, shape_name, mesh, absorb_mla)
        dargs = _distribute(list(args), list(specs), mesh)
        del args
        arg_bytes = _local_bytes(dargs)
        sh.set_active_mesh(mesh)
        try:
            with grad(), flopcount.Counter(arguments=dargs) as dev:
                out = fn(*dargs)
        finally:
            sh.set_active_mesh(None)
        out_bytes = _local_bytes(out)
        n_devices = mesh.size()
    finally:
        dist.destroy_process_group()
    return {"n_devices": n_devices, "global": glob, "device": dev,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             absorb_mla=False, tag="") -> dict:
    mesh_name = "multi" if multi_pod else "single"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "tag": tag, "status": "skip", "skip_reason": why}
    if ok:
        t0 = time.time()
        try:
            c = count_cell(arch, shape_name, multi_pod, absorb_mla)
            g, d = c["global"], c["device"].summary()
            record.update(
                status="ok", n_devices=c["n_devices"],
                run_s=round(time.time() - t0, 2),
                flops_global=g["flops"], dot_flops_global=g["dot_flops"],
                kernel_flops_global=g["kernel_flops"],
                bytes_global=g["bytes"],
                collective_bytes_per_device=d["collective_bytes"],
                collective_counts=d["collective_counts"],
                memory={"argument_bytes": c["argument_bytes"],
                        "output_bytes": c["output_bytes"],
                        "temp_bytes": d["peak_temp_bytes"],
                        "alias_bytes": None, "code_bytes": None},
                model_flops=model_flops(arch, shape_name))
            print(f"[ok] {arch} x {shape_name} x {mesh_name}"
                  f"{(' (' + tag + ')') if tag else ''}: "
                  f"{record['run_s']:.1f}s, "
                  f"flops {g['flops']:.4g} (dot {g['dot_flops']:.4g}), "
                  f"coll/dev {sum(d['collective_bytes'].values()):.3g}B")
            print("  memory:", record["memory"])
        except Exception as e:  # noqa: BLE001 -- record and continue
            record.update(status="error", error=f"{type(e).__name__}: {e}",
                          traceback=traceback.format_exc()[-2000:])
            print(f"[ERROR] {arch} x {shape_name} x {mesh_name}: {e}")
    else:
        print(f"[skip] {arch} x {shape_name}: {why}")

    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_name}{('__' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--absorb-mla", action="store_true",
                    help="decode with the absorbed-MLA optimization")
    ap.add_argument("--opt", action="store_true",
                    help="enable the beyond-paper optimizations (the "
                         "sharded flash-decode, gemma-2b's attn_chunk 4096)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.opt:
        from repro_torch.models import layers
        layers.SHARDED_DECODE_ATTN = True
        creg.ARCHS["gemma-2b"] = dataclasses.replace(creg.ARCHS["gemma-2b"],
                                                     attn_chunk=4096)
        if not args.tag:
            args.tag = "opt"

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape.name) for arch, _, shape, _, _ in all_cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, are required")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in cells:
        for mesh_name in meshes:
            fname = (f"{arch}__{shape_name}__{mesh_name}"
                     f"{('__' + args.tag) if args.tag else ''}.json")
            path = os.path.join(args.out, fname)
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skip"):
                        continue
            rec = run_cell(arch, shape_name, mesh_name == "multi", args.out,
                           absorb_mla=args.absorb_mla, tag=args.tag)
            if rec["status"] == "error":
                failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
