# Port of repro/models/registry.py: the Model API for decoder-only models on torch.
"""Unified Model API.

``build_model(arch_or_cfg, device=None)`` returns a ``Model`` whose
functions take and return nested dicts of tensors with the JAX package's
keys and per-group stacking:

    init_params(generator)               -> params on the model's device
    prefill(params, batch)               -> (last_logits [B,V], caches)
    decode(params, caches, batch)        -> (logits [B,V], caches)
    init_cache(batch, buf_len)           -> zeroed caches

``decode`` writes into ``caches`` in place: the new token's keys and
values, or the RWKV state and token shifts (the JAX engine donates the
buffers instead).  ``init_params`` draws from
the JAX initialisers' distributions, not their values; to run the JAX
package's params, convert them with ``models.convert.from_jax``.

The model runs on the card unless ``device="cpu"`` is asked for.  The
dense, MoE (without MLA) and RWKV families run; the encoder-decoder family
and ``train_loss`` wait for their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import common, decoder


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[[torch.Generator], Any]
    train_loss: Callable[[Any, Any], Any]
    prefill: Callable[[Any, Any], Any]
    decode: Callable[[Any, Any, Any], Any]
    init_cache: Callable[..., Any]


def _ctx_of(cfg, batch):
    if cfg.family == "vlm":
        return batch["vision_embeds"]
    return None


def _build_decoder_model(cfg: ModelConfig, device: torch.device) -> Model:
    def init_params(generator):
        return decoder.init_decoder(generator, cfg, device)

    def train_loss(params, batch):
        raise NotImplementedError("train_loss waits for the training slice")

    def prefill(params, batch):
        x = common.embed(params["embed"], cfg, batch["tokens"])
        x, caches = decoder.decoder_stack(params, cfg, x, mode="prefill",
                                          ctx=_ctx_of(cfg, batch))
        logits = common.unembed(params["embed"], cfg, x[:, -1:, :])
        return logits[:, 0, :], caches

    def decode(params, caches, batch):
        x = common.embed(params["embed"], cfg, batch["token"])
        x, caches = decoder.decoder_stack(params, cfg, x, mode="decode",
                                          caches=caches, pos=batch["pos"])
        logits = common.unembed(params["embed"], cfg, x)
        return logits[:, 0, :], caches

    def init_cache(batch_size, buf_len, ctx_len=None, device=device):
        del ctx_len  # vlm ctx length is fixed by the vision stub
        n_ctx = cfg.vision.n_vision_tokens if cfg.vision else 0
        return decoder.init_decoder_cache(cfg, batch_size, buf_len, n_ctx,
                                          device)

    return Model(cfg, device, init_params, train_loss, prefill, decode,
                 init_cache)


def build_model(arch_or_cfg, device=None) -> Model:
    cfg = (arch_or_cfg if isinstance(arch_or_cfg, ModelConfig)
           else get_config(arch_or_cfg))
    if cfg.family == "audio":
        raise NotImplementedError(
            "the encoder-decoder family waits for the encoder-decoder slice")
    return _build_decoder_model(cfg, resolve_device(device))
