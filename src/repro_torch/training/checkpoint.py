# Port of repro/training/checkpoint.py: the same checkpoints, written from and read into tensors.
"""Fault-tolerant checkpointing: atomic save, restore, resume discovery.

numpy ``.npz`` snapshots of the flattened train state, keyed by the JAX
package's path strings (``['params']/['groups']/[0]/['attn']/['wq']``,
``_tree.tree_leaves_with_paths``), so a checkpoint crosses between the two
packages.  bfloat16 leaves are written as the 2-byte void (``|V2``) that
numpy writes for an ``ml_dtypes`` bfloat16 array, and read back bit for bit,
so neither side needs ``ml_dtypes`` to read the other's.  Writes are
crash-safe (a temporary file, then ``os.replace``) and old checkpoints are
garbage-collected.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._tree import tree_leaves_with_paths, tree_map

_STEP_RE = re.compile(r"ckpt_(\d+)\.npz$")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _to_torch(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype and device; a 2-byte void
    array holds bfloat16 bits."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=like.device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Atomically write ``ckpt_<step>.npz``; prune to the newest ``keep``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: _to_numpy(leaf)
              for key, leaf in tree_leaves_with_paths(state)}
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        final = os.path.join(ckpt_dir, f"ckpt_{step}.npz")
        os.replace(tmp, final)  # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    manifest = {"latest_step": step}
    mtmp = os.path.join(ckpt_dir, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, "manifest.json"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        try:
            os.unlink(os.path.join(ckpt_dir, f"ckpt_{s}.npz"))
        except OSError:
            pass


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``template`` (shapes must match): new
    tensors of the template leaves' dtypes, on their devices."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(os.path.join(ckpt_dir, f"ckpt_{step}.npz")) as data:
        arrays = dict(data)
    loaded = []
    for key, leaf in tree_leaves_with_paths(template):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs "
                f"template {tuple(leaf.shape)}")
        loaded.append((id(leaf), _to_torch(arr, leaf)))
    by_leaf = dict(loaded)
    return tree_map(lambda leaf: by_leaf[id(leaf)], template)
