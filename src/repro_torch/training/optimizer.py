# Port of repro/training/optimizer.py: AdamW with warmup-cosine on torch, the same f32 expressions, updated in place.
"""AdamW with a warmup-cosine schedule, built from scratch.

The JAX package's update, expression for expression in f32 and in the same
order, on nested dicts of tensors.  Where JAX returns new trees, the port
updates params, m and v in place (the step counter is a new tensor): a
train state of qwen3-4b is 53 GB (8.8 GB bf16 params, 8.8 GB grads, 35.3 GB
f32 moments), and an update that built the expression's f32 temporaries
over a whole stacked leaf (the 36-layer MLP weights, 0.9 B elements) would
take several GB for each.  So each leaf is updated in slices of at most
``CHUNK`` elements, along its first dimension, and where one index of it
holds more (a stack of one layer: deepseek-v2's experts, 1.26 B elements
a layer), along the next dimension within it; the update is elementwise,
so slicing changes none of its numbers.  The global norm sums each slice's
squares in f32, then each leaf's slices and the leaves in order: a
summation order of its own, as the JAX package's is XLA's.

Leaves may be DTensors (a sharded train state).  The update then runs on
each leaf's local shard (a param, its gradient and its moments laid out
alike), and the global norm counts each element once: each leaf's local
squares are summed as above, then summed over the mesh dims that shard
the leaf (none for a replicated one).  On plain tensors, or on one device,
the order of summation is the one above.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch._tree import tree_leaves

CHUNK = 1 << 26   # elements of a leaf updated at once (268 MB in f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def _zeros_like_f32(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like_f32(v) for v in tree]
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def init_opt_state(params):
    """f32 zeros of every leaf's shape for m and v, and an int32 step."""
    device = tree_leaves(params)[0].device
    return {"m": _zeros_like_f32(params), "v": _zeros_like_f32(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int32 tensor), f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1.0) / cfg.warmup_steps, max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def _slices(t):
    """Views of ``t`` of at most ``CHUNK`` elements each, in index order:
    runs of whole rows along its first dimension, or, where one row holds
    more, each row's own slices (a 1-D tensor longer than ``CHUNK`` is cut
    into runs of elements)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    row = t.numel() // t.shape[0]
    if row > CHUNK:
        return [s for i in range(t.shape[0]) for s in _slices(t[i])]
    rows = CHUNK // row
    return [t[i:i + rows] for i in range(0, t.shape[0], rows)]


def _squares(leaf):
    """The leaf's f32 sum of squares: over its slices, then the slices'
    sums; a DTensor's over its local shard, then summed over the mesh dims
    that shard it (pending sums reduced first)."""
    if not isinstance(leaf, DTensor):
        return torch.stack([s.float().square().sum()
                            for s in _slices(leaf)]).sum()
    mesh = leaf.device_mesh
    leaf = leaf.redistribute(mesh, [Replicate() if p.is_partial() else p
                                    for p in leaf.placements])
    total = _squares(leaf.to_local())
    for m, p in enumerate(leaf.placements):
        if isinstance(p, Shard):
            dist.all_reduce(total, group=mesh.get_group(m))
    return total


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [_squares(leaf) for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def _local(leaf, like):
    """The local shard of DTensor ``leaf`` laid out as ``like``'s, or the
    plain tensor itself."""
    if not isinstance(leaf, DTensor):
        return leaf
    if list(leaf.placements) != list(like.placements):
        leaf = leaf.redistribute(like.device_mesh, like.placements)
    return leaf.to_local()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """Returns (params, opt_state, metrics): params, m and v updated in
    place, a new step; metrics {"lr", "grad_norm"}."""
    step = opt_state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, opt_state["step"])
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.full_like(stepf, b1) ** stepf
    bc2 = 1.0 - torch.full_like(stepf, b2) ** stepf

    def upd(p, g, m, v, matrix):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
        if matrix:       # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"leaf shapes differ: {p.shape}, {g.shape}, "
                             f"{m.shape}, {v.shape}")
        matrix = p.dim() >= 2
        if isinstance(p, DTensor):
            if not (isinstance(m, DTensor) and isinstance(v, DTensor)
                    and list(p.placements) == list(m.placements)
                    == list(v.placements)):
                raise ValueError("a sharded param and its moments must be "
                                 f"laid out alike: {p.placements}")
            p, g, m, v = (_local(t, p) for t in (p, g, m, v))
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            upd(ps, gs, ms, vs, matrix)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, new_state, {"lr": lr, "grad_norm": gn}
