"""The JAX package's model params, as numpy, turned into the port's params.

``from_jax(tree, cfg, device)`` takes the tree that the JAX package's
``model.init_params(...)`` returns, after ``jax.tree.map(np.asarray, ...)``,
and returns the same nested dict of tensors on ``device``, dtype for dtype:
the port keeps the JAX keys and the per-group stacking, so the map is
structural (an MoE layer's ``moe`` subtree too, its f32 router staying
f32, a hymba layer's f32 ``A_log`` too), and an encoder-decoder model's
``encoder`` subtree, its ``layers`` stacked over ``n_enc_layers``.  bfloat16
arrays (numpy's ``ml_dtypes`` type) keep their bits.

``train_state_from_jax(state, cfg, device)`` does the same for a JAX train
state (``{"params", "opt": {"m", "v", "step"}}``, numpy leaves): the params
through ``from_jax``, the f32 moments as they are, the int32 step.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import build_layout


def to_torch(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 bit for bit."""
    a = np.array(a, copy=True, order="C")    # writable, owned by the tensor
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax(tree, cfg: ModelConfig, device=None):
    """The port's params from the JAX package's params (numpy leaves)."""
    device = resolve_device(device)
    groups = build_layout(cfg)
    keys = {"embed", "groups"} | ({"encoder"} if cfg.encdec else set())
    if set(tree) != keys or len(tree["groups"]) != len(groups):
        raise ValueError(f"not a {cfg.name} tree: {sorted(tree)}, "
                         f"{len(tree.get('groups', []))} groups for "
                         f"{len(groups)}")
    stacks = [(g.n, gtree) for g, gtree in zip(groups, tree["groups"])]
    if cfg.encdec:
        if set(tree["encoder"]) != {"layers", "final_norm"}:
            raise ValueError(f"not an encoder tree: {sorted(tree['encoder'])}")
        stacks.append((cfg.encdec.n_enc_layers, tree["encoder"]["layers"]))
    for n, gtree in stacks:
        lead = {np.shape(a)[0] for a in tree_leaves(gtree)}
        if lead != {n}:
            raise ValueError(f"group of {n} layers has leading dims {lead}")
    return tree_map(lambda a: to_torch(a, device), tree)


def train_state_from_jax(state, cfg: ModelConfig, device=None):
    """The port's train state from the JAX package's (numpy leaves)."""
    device = resolve_device(device)
    opt = state["opt"]
    if set(state) != {"params", "opt"} or set(opt) != {"m", "v", "step"}:
        raise ValueError(f"not a train state: {sorted(state)}, "
                         f"{sorted(opt)}")
    moments = {}
    for key in ("m", "v"):
        dtypes = {np.asarray(a).dtype for a in tree_leaves(opt[key])}
        if dtypes != {np.dtype(np.float32)}:
            raise ValueError(f"opt.{key} is {dtypes}, not float32")
        moments[key] = from_jax(opt[key], cfg, device)
    step = torch.from_numpy(np.array(opt["step"], dtype=np.int32)).to(device)
    return {"params": from_jax(state["params"], cfg, device),
            "opt": dict(moments, step=step)}
