# Port of repro/training/train_step.py: the train step on torch (autograd over the param leaves, microbatches accumulated in f32).
"""The train step driven by the train launcher.

``make_train_step(model, opt_cfg, accum_steps)`` returns
``train_step(state, batch) -> (state, metrics)``: the loss and its gradient
with respect to every param leaf (``torch.autograd.grad``, where JAX takes
``jax.value_and_grad``), then ``adamw_update``, which updates the state's
tensors in place.  ``accum_steps > 1`` splits the batch into microbatches
along its first dimension and accumulates their gradients in f32, as the
JAX step's ``lax.scan`` does.  ``grad_shardings`` (a tree of
``distributed.sharding.to_shardings``'s ``(mesh, placements)`` pairs, the
JAX step's ZeRO constraint) redistributes each gradient, and each
microbatch's, to its sharding before the update; the state is then a tree
of DTensors (``sharding.distribute``), and the step runs under
``sharding.mesh_aware``.
"""

from __future__ import annotations

import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.distributed.sharding import mesh_aware
from repro_torch.models.registry import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)


def init_train_state(model: Model, generator: torch.Generator,
                     opt_cfg: AdamWConfig | None = None):
    params = model.init_params(generator)
    return {"params": params, "opt": init_opt_state(params)}


def _value_and_grad(model: Model, params, batch):
    """(loss, grads): grads a tree like ``params``, each leaf's gradient in
    its dtype (zeros for a leaf the loss does not use, as ``jax.grad``)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    loss = model.train_loss(tree_map(lambda _: next(it), params), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _microbatch(batch, accum_steps, i):
    """Microbatch ``i`` of ``accum_steps``: a leading dimension that
    divides is split, anything else is passed whole (JAX broadcasts it)."""
    out = {}
    for key, a in batch.items():
        if a.dim() >= 1 and a.shape[0] % accum_steps == 0:
            n = a.shape[0] // accum_steps
            out[key] = a[i * n:(i + 1) * n]
        else:
            out[key] = a
    return out


def _constrain(grads, grad_shardings):
    if grad_shardings is None:
        return grads
    return tree_map(lambda g, s: g.redistribute(*s), grads, grad_shardings)


def loss_and_grads(model: Model, params, batch, accum_steps: int = 1,
                   grad_shardings=None):
    """The loss and the gradient tree of ``batch`` (the step before the
    update): one pass, or ``accum_steps`` microbatches whose losses and
    gradients are summed in f32 and divided by ``accum_steps``; each
    gradient redistributed to ``grad_shardings`` where it is given."""
    if accum_steps == 1:
        loss, grads = _value_and_grad(model, params, batch)
        return loss, _constrain(grads, grad_shardings)
    device = tree_leaves(params)[0].device
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    gacc = _constrain(tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params), grad_shardings)
    for i in range(accum_steps):
        loss, grads = _value_and_grad(model, params,
                                      _microbatch(batch, accum_steps, i))
        grads = _constrain(grads, grad_shardings)
        for a, g in zip(tree_leaves(gacc), tree_leaves(grads)):
            a.add_(g.float())
        del grads
        loss_sum = loss_sum + loss
    for a in tree_leaves(gacc):
        a.div_(accum_steps)
    return loss_sum / accum_steps, gacc


def make_train_step(model: Model, opt_cfg: AdamWConfig | None = None,
                    grad_shardings=None, accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; metrics are the
    optimizer's {"lr", "grad_norm"} and the "loss", 0-d tensors."""
    opt_cfg = opt_cfg or AdamWConfig()

    @mesh_aware
    def train_step(state, batch):
        loss, grads = loss_and_grads(model, state["params"], batch,
                                     accum_steps, grad_shardings)
        params, opt, metrics = adamw_update(opt_cfg, state["params"], grads,
                                            state["opt"])
        del grads
        return {"params": params, "opt": opt}, dict(metrics, loss=loss)

    return train_step
