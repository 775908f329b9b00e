"""The model-facing kernel wrappers on DTensors.

A wrapper that is handed DTensors runs its kernel, or on CPU tensors its
plain version, on the local shards that
``torch.distributed.tensor.experimental.local_map`` hands it, after
redistributing each input to the layout the call can take: a dim whose
slices the kernel computes independently (batch, heads, tokens) keeps its
shard where it divides evenly, and every other dim is made whole, pending
sums reduced.  The output carries the placements that the local call
implies.  The kernel itself, its checks and its launch counter see only the
local tensors, so each rank counts its own launches.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def kept(x, sizes) -> list:
    """Placements for DTensor ``x``: each ``Shard(d)`` with d in ``sizes``
    kept where ``sizes[d]`` divides by the product of the mesh dims that
    shard d, every other placement ``Replicate()``."""
    mesh = x.device_mesh
    out = [Replicate()] * mesh.ndim
    for d, size in sizes.items():
        idx = [i for i, p in enumerate(x.placements)
               if isinstance(p, Shard) and p.dim == d]
        if idx and size % math.prod(mesh.size(i) for i in idx) == 0:
            for i in idx:
                out[i] = Shard(d)
    return out


def moved(pl, dims) -> list:
    """``pl`` with each ``Shard(d)`` moved to ``Shard(dims[d])``: the same
    split on another tensor's dim."""
    return [Shard(dims[p.dim]) if isinstance(p, Shard) else p for p in pl]


def summed_over(pl, dim, other=None) -> list:
    """The gradient placements of an input that is whole along the mesh
    dims where ``pl`` shards ``dim`` (a weight read by every token of a
    token shard): there each rank's gradient is a partial sum; elsewhere
    ``other`` (default: ``pl`` itself)."""
    other = pl if other is None else other
    return [Partial() if isinstance(p, Shard) and p.dim == dim else o
            for p, o in zip(pl, other)]


def call(fn, args, in_placements, out_placements, in_grad_placements=None):
    """``fn(*local args)`` under ``local_map`` on the mesh of the first
    DTensor of ``args``; a plain tensor among them is taken as replicated
    (every rank holds the same values, as ``implicit_replication`` takes
    it).  ``in_grad_placements`` default to ``in_placements``."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    args = tuple(a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if in_grad_placements is None
                                         else tuple(in_grad_placements)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)
