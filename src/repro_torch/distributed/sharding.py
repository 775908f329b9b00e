# Port of repro/distributed/sharding.py: the logical-axis rules and PartitionSpecs, as DTensor placements on a torch DeviceMesh.
"""Logical-axis sharding rules -> PartitionSpecs for params, optimizer
state, batches and caches, with divisibility fallback; and their DTensor
placements on a ``DeviceMesh``.

The rule system is MaxText-style: every parameter leaf is matched (by its
tree path) to a tuple of logical axis names; a rule table maps logical axes
to mesh axes.  A dimension is only sharded if its size divides the mesh-axis
size and the mesh axis is not already used by an earlier dimension of the
same tensor -- so GQA heads that don't divide the model axis, batch=1
long-context decode, and the 2-pod mesh all degrade gracefully to
replication instead of failing.

The tables and the spec functions are the JAX package's, on the port's
trees (nested dicts and lists of tensors, shape-only ones on the meta
device).  ``placements`` is the one conversion from a spec to DTensor
placements.  The activation constraints (``constrain_*``) are the identity
off a mesh and on plain tensors; on a DTensor they redistribute it to the
JAX function's spec.  The JAX package's ``sharded_decode_attention`` (a
``shard_map`` flash-decode) has no counterpart here yet.
"""

from __future__ import annotations

import fnmatch
import functools
import math

from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

# ---------------------------------------------------------------------------
# leaf path -> logical axes

# evaluated top-down, first match wins; patterns match the dot-joined path
# *without* the group index (e.g. "groups.attn.wq", "embed.tok")
PARAM_AXES = [
    ("embed.tok", ("vocab", "embed")),
    ("embed.head", ("embed", "vocab")),
    ("*wq_a", ("layers", "embed", "lora")),
    ("*wq_b", ("layers", "lora", "heads", "head_dim")),
    ("*wkv_a", ("layers", "embed", "lora")),
    ("*wk_b", ("layers", "lora", "heads", "head_dim")),
    ("*wv_b", ("layers", "lora", "heads", "head_dim")),
    ("*attn.wq", ("layers", "embed", "heads", "head_dim")),
    ("*attn.wk", ("layers", "embed", "kv_heads", "head_dim")),
    ("*attn.wv", ("layers", "embed", "kv_heads", "head_dim")),
    ("*attn.wo", ("layers", "heads", "head_dim", "embed")),
    ("*cross.wq", ("layers", "embed", "heads", "head_dim")),
    ("*cross.wk", ("layers", "embed", "kv_heads", "head_dim")),
    ("*cross.wv", ("layers", "embed", "kv_heads", "head_dim")),
    ("*cross.wo", ("layers", "heads", "head_dim", "embed")),
    ("*moe.router", ("layers", "embed", None)),
    ("*moe.shared.wi", ("layers", "embed", "mlp")),
    ("*moe.shared.wg", ("layers", "embed", "mlp")),
    ("*moe.shared.wo", ("layers", "mlp", "embed")),
    ("*moe.wi", ("layers", "experts", "expert_embed", "expert_mlp")),
    ("*moe.wg", ("layers", "experts", "expert_embed", "expert_mlp")),
    ("*moe.wo", ("layers", "experts", "expert_mlp", "expert_embed")),
    ("*mlp.wi", ("layers", "embed", "mlp")),
    ("*mlp.wg", ("layers", "embed", "mlp")),
    ("*mlp.wo", ("layers", "mlp", "embed")),
    # rwkv time-mix / channel-mix
    ("*tm.lora_*_a", ("layers", "embed", "lora")),
    ("*tm.lora_*_b", ("layers", "lora", "embed")),
    ("*tm.w0", ("layers", "embed")),
    ("*tm.u", ("layers", "embed")),
    ("*tm.mu_*", ("layers", "embed")),
    ("*tm.ln_x", ("layers", "embed")),
    ("*tm.wo", ("layers", "hidden", "embed")),
    ("*tm.w*", ("layers", "embed", "hidden")),
    ("*cm.mu_*", ("layers", "embed")),
    ("*cm.wk", ("layers", "embed", "mlp")),
    ("*cm.wv", ("layers", "mlp", "embed")),
    ("*cm.wr", ("layers", "embed", "hidden")),
    # mamba branch
    ("*mamba.in_proj", ("layers", "embed", "inner")),
    ("*mamba.conv_w", ("layers", None, "inner")),
    ("*mamba.x_proj", ("layers", "inner", None)),
    ("*mamba.dt_proj", ("layers", None, "inner")),
    ("*mamba.dt_bias", ("layers", "inner")),
    ("*mamba.A_log", ("layers", "inner", None)),
    ("*mamba.Dskip", ("layers", "inner")),
    ("*mamba.out_proj", ("layers", "inner", "embed")),
    # norms / gates / everything else: replicate (layers dim kept logical)
    ("*", None),
]

# logical axis -> mesh axis (or tuple of mesh axes)
PARAM_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "hidden": "model",
    "inner": "model",
    "experts": "model",
    "expert_embed": "data",   # 2D expert-weight sharding (deepseek-scale)
    "embed": None,
    "head_dim": None,
    "layers": None,
    "lora": None,
    "expert_mlp": None,
}

# optimizer state additionally shards big replicated dims over data (ZeRO-1),
# and over the pod axis on the multi-pod mesh (falls back gracefully when
# the mesh has no 'pod' axis or the layer count doesn't divide)
OPT_EXTRA = {"embed": "data", "layers": "pod"}

# training params are FSDP-sharded over data as well; inference keeps
# TP-only params for low-latency decode.
TRAIN_RULES = dict(PARAM_RULES, embed="data", layers="pod")


class PartitionSpec(tuple):
    """A tensor's sharding, ``jax.sharding.PartitionSpec``'s counterpart:
    entry d is the mesh axis that splits dim d, a tuple of axes (the first
    major), or None; trailing Nones are dropped where a spec is made."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    structure; ``path`` holds dict keys and list indices; None stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)


def _path_str(path) -> str:
    # drop group indices so patterns stay stable
    return ".".join(str(p) for p in path if not isinstance(p, int))


def _axes_for(path_str: str):
    for pat, axes in PARAM_AXES:
        if fnmatch.fnmatch(path_str, pat):
            return axes
    return None


def _mesh_sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _resolve(axes, shape, mesh, rules) -> P:
    """Logical axes -> PartitionSpec with divisibility + reuse fallback."""
    if axes is None:
        return P()
    sizes = _mesh_sizes(mesh)
    # stacked group params may have one more leading dim than the logical
    # spec (vlm/hymba single-layer groups are stacked with n=1); pad left
    axes = tuple(axes)
    if len(axes) < len(shape):
        axes = (None,) * (len(shape) - len(axes)) + axes
    elif len(axes) > len(shape):
        axes = axes[len(axes) - len(shape):]
    used = set()
    out = []
    for dim, ax in zip(shape, axes):
        mesh_ax = rules.get(ax) if ax else None
        if mesh_ax is None:
            out.append(None)
            continue
        maxes = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        maxes = tuple(m for m in maxes if m in sizes)
        total = math.prod(sizes[m] for m in maxes)
        if (not maxes or any(m in used for m in maxes)
                or dim % total != 0):
            out.append(None)
            continue
        used.update(maxes)
        out.append(mesh_ax)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_pspecs(params_tree, mesh, rules=None):
    """PartitionSpec tree for a (shape-only or real) params tree."""
    rules = rules or PARAM_RULES

    def one(path, leaf):
        return _resolve(_axes_for(_path_str(path)), leaf.shape, mesh, rules)

    return _map_with_path(one, params_tree)


def opt_pspecs(params_tree, mesh):
    rules = dict(PARAM_RULES, **OPT_EXTRA)
    return param_pspecs(params_tree, mesh, rules)


def dp_axes(mesh):
    """The data-parallel mesh axes: ('pod','data') on the multi-pod mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _dp_total(mesh):
    sizes = _mesh_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def batch_pspecs(batch_tree, mesh):
    """Shard the leading batch dim over the DP axes; everything else
    replicated.  Scalars (decode pos) stay fully replicated."""
    dp = dp_axes(mesh)
    dp_total = _dp_total(mesh)

    def one(_, leaf):
        if leaf.dim() == 0:
            return P()
        if leaf.shape[0] % dp_total == 0:
            return P(dp if len(dp) > 1 else dp[0])
        return P()

    return _map_with_path(one, batch_tree)


def cache_pspecs(cache_tree, mesh):
    """Decode-cache sharding: batch dim (axis 1, after the stacked-group
    axis) over DP; the largest remaining dim (KV sequence, recurrent heads,
    or inner channels) over 'model' when divisible."""
    dp = dp_axes(mesh)
    dp_total = _dp_total(mesh)
    model = _mesh_sizes(mesh).get("model", 1)

    def one(_, leaf):
        if leaf.dim() <= 1:
            return P()
        spec = [None] * leaf.dim()
        if leaf.shape[1] % dp_total == 0:
            spec[1] = dp if len(dp) > 1 else dp[0]
        tail = [(s, i) for i, s in enumerate(leaf.shape) if i >= 2]
        for s, i in sorted(tail, reverse=True):
            if s % model == 0 and model > 1:
                spec[i] = "model"
                break
        while spec and spec[-1] is None:
            spec.pop()
        return P(*spec)

    return _map_with_path(one, cache_tree)


# ---------------------------------------------------------------------------
# specs -> DTensor placements


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    in mesh order, ``Shard(d)`` where tensor dim d's entry names that axis,
    else ``Replicate()``.  A tuple entry shards its dim over each of its
    axes, the first major, which is DTensor's left-to-right order; its axes
    must come in mesh order."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"{spec}: the axes of entry {entry!r} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} is named "
                                 "twice")
            out[i] = Shard(d)
    return out


def _spec_map(fn, spec_tree):
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _spec_map(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return [_spec_map(fn, v) for v in spec_tree]
    return spec_tree   # None: a leaf the tree does not have


def local_offset(t, dim) -> int:
    """The global index of the first element of DTensor ``t``'s local shard
    along ``dim`` (even shards, the first mesh dim major)."""
    mesh, coord, shard = t.device_mesh, t.device_mesh.get_coordinate(), 0
    for m, p in enumerate(t.placements):
        if p == Shard(dim):
            shard = shard * mesh.size(m) + coord[m]
    return shard * t.to_local().shape[dim]


def local_part(x, like, whole_dims):
    """The local tensor of ``x`` laid out as DTensor ``like``, except along
    ``whole_dims``, where it is whole on every rank (pending sums reduced);
    a plain ``x`` is taken as replicated."""
    mesh = like.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    pl = [Replicate() if p.is_partial() or (isinstance(p, Shard)
                                            and p.dim in whole_dims) else p
          for p in like.placements]
    return x.redistribute(mesh, pl).to_local()


def to_shardings(pspec_tree, mesh):
    """A tree of ``(mesh, placements)`` pairs, one for each spec."""
    return _spec_map(lambda s: (mesh, placements(s, mesh)), pspec_tree)


def distribute(tree, shardings):
    """``tree``'s tensors as DTensors, each by its ``(mesh, placements)``
    in ``shardings`` (a tree of ``to_shardings``'s form)."""
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [distribute(v, s) for v, s in zip(tree, shardings)]
    if tree is None:
        return None
    mesh, pl = shardings
    return distribute_tensor(tree, mesh, pl)


# --- activation sharding constraints ---------------------------------------
# The active mesh is set by the caller that distributes the inputs; model
# code reads it through the constraints below.
_ACTIVE_MESH: list = [None]


def set_active_mesh(mesh):
    _ACTIVE_MESH[0] = mesh


def get_active_mesh():
    return _ACTIVE_MESH[0]


def mesh_aware(fn):
    """``fn`` under DTensor's ``implicit_replication`` while a mesh is
    active, so that the plain tensors a model makes inside (positions,
    masks, constants, the same on every rank) join DTensor operations as
    replicated; off a mesh ``fn`` itself runs.  Only the outermost call
    enters the context: leaving it switches implicit replication off
    rather than back, so a nested call (a model's forward inside the train
    step) would switch it off under the backward that follows."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if get_active_mesh() is None or _IMPLICIT[0]:
            return fn(*args, **kwargs)
        _IMPLICIT[0] = True
        try:
            with implicit_replication():
                return fn(*args, **kwargs)
        finally:
            _IMPLICIT[0] = False
    return wrapped


_IMPLICIT = [False]     # a ``mesh_aware`` call is running


def _mesh_of(x):
    """The active mesh where ``x`` is a DTensor, else None."""
    mesh = get_active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return None
    return mesh


def _constrain(x, mesh, spec):
    return x.redistribute(mesh, placements(spec, mesh))


def constrain_tokens(x):
    """Shard a flattened token tensor [T, ...] over every DP axis and the
    model axis jointly."""
    mesh = _mesh_of(x)
    if mesh is None:
        return x
    axes = tuple(mesh.mesh_dim_names)
    if x.dim() < 2 or x.shape[0] % mesh.size() != 0:
        return x
    return _constrain(x, mesh, P(axes))


def _dp_axis(mesh, batch_dim):
    dp = dp_axes(mesh)
    if not dp or batch_dim % _dp_total(mesh) != 0:
        return None
    return dp if len(dp) > 1 else dp[0]


def constrain_moe_groups(xg):
    """[B, G, g, D] token groups: batch over DP, groups over 'model' --
    matching the sequence-parallel residual stream so no reshard happens
    on MoE entry/exit."""
    mesh = _mesh_of(xg)
    if mesh is None or "model" not in mesh.mesh_dim_names or xg.dim() != 4:
        return xg
    sizes = _mesh_sizes(mesh)
    g_ax = "model" if (xg.shape[1] % sizes["model"] == 0
                       and xg.shape[1] > 1) else None
    return _constrain(xg, mesh, P(_dp_axis(mesh, xg.shape[0]), g_ax))


def constrain_moe_expert(t):
    """[B, G, E, C, D] expert-major tensors: experts over 'model'."""
    mesh = _mesh_of(t)
    if mesh is None or "model" not in mesh.mesh_dim_names or t.dim() != 5:
        return t
    sizes = _mesh_sizes(mesh)
    e_ax = "model" if t.shape[2] % sizes["model"] == 0 else None
    return _constrain(t, mesh, P(_dp_axis(mesh, t.shape[0]), None, e_ax))


# runtime knob: sequence-parallel residual stream on/off.
SEQ_SHARD = True


def constrain_seq(x):
    """Megatron-style sequence parallelism: shard the residual stream's
    sequence dim over 'model' between layers.  The identity off a mesh, on
    a plain tensor, or where the shape doesn't divide -- safe to call
    unconditionally from model code."""
    mesh = _mesh_of(x)
    if not SEQ_SHARD or mesh is None or "model" not in mesh.mesh_dim_names:
        return x
    sizes = _mesh_sizes(mesh)
    if x.dim() < 3 or x.shape[1] % sizes["model"] != 0 or x.shape[1] <= 1:
        return x
    return _constrain(x, mesh, P(_dp_axis(mesh, x.shape[0]), "model"))
