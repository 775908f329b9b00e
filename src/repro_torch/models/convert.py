"""The JAX package's model params, as numpy, turned into the port's params.

``from_jax(tree, cfg, device)`` takes the tree that the JAX package's
``model.init_params(...)`` returns, after ``jax.tree.map(np.asarray, ...)``,
and returns the same nested dict of tensors on ``device``, dtype for dtype:
the port keeps the JAX keys and the per-group stacking, so the map is
structural (an MoE layer's ``moe`` subtree too, its f32 router staying
f32).  bfloat16 arrays (numpy's ``ml_dtypes`` type) keep their bits.
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
    if set(tree) != {"embed", "groups"} or len(tree["groups"]) != len(groups):
        raise ValueError(f"not a {cfg.name} decoder tree: {sorted(tree)}, "
                         f"{len(tree.get('groups', []))} groups for "
                         f"{len(groups)}")
    for g, gtree in zip(groups, tree["groups"]):
        lead = {np.shape(a)[0] for a in tree_leaves(gtree)}
        if lead != {g.n}:
            raise ValueError(f"group of {g.n} layers has leading dims {lead}")
    return tree_map(lambda a: to_torch(a, device), tree)
