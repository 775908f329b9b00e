# Port of repro/models/registry.py: the Model API for decoder-only and encoder-decoder models on torch.
"""Unified Model API.

``build_model(arch_or_cfg, device=None)`` returns a ``Model`` whose
functions take and return nested dicts of tensors with the JAX package's
keys and per-group stacking:

    init_params(generator)               -> params on the model's device
    train_loss(params, batch)            -> scalar f32 loss
    prefill(params, batch)               -> (last_logits [B,V], caches)
    decode(params, caches, batch)        -> (logits [B,V], caches)
    init_cache(batch, buf_len, ctx_len)  -> zeroed caches

``decode`` writes into ``caches`` in place: the new token's keys and
values, or the RWKV state and token shifts (the JAX engine donates the
buffers instead).  ``init_params`` draws from
the JAX initialisers' distributions, not their values; to run the JAX
package's params, convert them with ``models.convert.from_jax``.

``prefill`` and ``decode`` take ``absorb_mla`` (MLA models: decode attends
in the latent space; the default False is the paper-faithful baseline).
A VLM's prefill batch carries ``vision_embeds`` [B, n_vision_tokens, D],
the context of its cross layers; decode reads their caches instead, which
``init_cache`` sizes to ``n_vision_tokens``.  An encoder-decoder model's
(seamless-m4t) prefill batch carries ``audio_embeds`` [B, S_src, D], which
its encoder turns into the context of every decoder layer's cross-attention;
its ``init_cache`` sizes the cross caches to ``ctx_len`` (``buf_len`` when
None).

The model runs on the card unless ``device="cpu"`` is asked for.  Every
family of the registry runs (dense, MoE with MLA too, RWKV, hybrid hymba,
VLM, encoder-decoder).  ``train_loss`` (a batch of ``tokens`` and
``labels`` [B, S], a VLM's with ``vision_embeds``, an encoder-decoder's
with ``audio_embeds``) is the JAX package's: the decoder stack in train
mode, then ``chunked_ce_loss``.  Every family trains.

``input_specs(shape)`` gives the batch of a ``SHAPES`` cell as meta
tensors of the JAX package's shapes and dtypes (tokens int32).  A model
built with ``device="meta"`` gives shape-only params and caches, at full
config and without allocating (the spec functions of
``distributed.sharding`` read them).  Params, caches and batches may be
DTensors (``distributed.sharding.distribute``): the forward functions then
run under ``sharding.mesh_aware`` while a mesh is active, and the kernel
wrappers compute on local shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.distributed.sharding import mesh_aware
from repro_torch.models import common, decoder


def _vocab_whole(logits, labels):
    """Logits [B, S, V] whole over V and labels [B, S] laid out as the
    logits' B and S where they are DTensors: the gold logit's gather then
    needs no communication (DTensor's rule would otherwise shard it over V,
    leaving a result that its own redistribution cannot reduce)."""
    logits = common.whole(logits, [-1])
    if isinstance(logits, DTensor):
        if not isinstance(labels, DTensor):
            labels = DTensor.from_local(
                labels, logits.device_mesh,
                [Replicate()] * logits.device_mesh.ndim)
        labels = labels.redistribute(logits.device_mesh, logits.placements)
    return logits, labels


def cross_entropy(logits, labels):
    """logits: [B, S, V] (any float dtype), labels: [B, S] integers."""
    logits, labels = _vocab_whole(logits.float(), labels)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


CE_CHUNK = 512  # sequence tokens per loss chunk


def chunked_ce_loss(params, cfg, x, labels):
    """Cross-entropy without materializing the full [B, S, V] logits.

    The unembed and logsumexp run per sequence chunk of ``CE_CHUNK`` tokens
    (when S is a larger multiple of it), each under ``checkpoint``, so the
    backward recomputes a chunk's logits and the peak logits buffer is
    S / CE_CHUNK times smaller, as the JAX package's remat of its scan
    body."""
    B, S, D = x.shape
    n = S // CE_CHUNK if (S % CE_CHUNK == 0 and S > CE_CHUNK) else 1
    if n == 1:
        return cross_entropy(common.unembed(params["embed"], cfg, x), labels)
    c = S // n

    def chunk(xi, yi):
        logits, yi = _vocab_whole(
            common.unembed(params["embed"], cfg, xi).float(), yi)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yi[..., None].long())[..., 0]
        return (lse - gold).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        total = total + checkpoint(chunk, x[:, i * c:(i + 1) * c],
                                   labels[:, i * c:(i + 1) * c],
                                   use_reentrant=False)
    return total / (B * S)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable[[torch.Generator], Any]
    train_loss: Callable[[Any, Any], Any]
    prefill: Callable[[Any, Any], Any]
    decode: Callable[[Any, Any, Any], Any]
    init_cache: Callable[..., Any]
    input_specs: Callable[[ShapeCell], Any]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _model(cfg, device, init_params, train_loss, prefill, decode, init_cache,
           input_specs):
    """The ``Model``; its forward functions run under ``mesh_aware``."""
    return Model(cfg, device, init_params, mesh_aware(train_loss),
                 mesh_aware(prefill), mesh_aware(decode), init_cache,
                 input_specs)


def _ctx_of(cfg, batch):
    if cfg.family == "vlm":
        return batch["vision_embeds"]
    return None


def _build_decoder_model(cfg: ModelConfig, device: torch.device) -> Model:
    def init_params(generator):
        return decoder.init_decoder(generator, cfg, device)

    def train_loss(params, batch):
        x = common.embed(params["embed"], cfg, batch["tokens"])
        x, _ = decoder.decoder_stack(params, cfg, x, mode="train",
                                     ctx=_ctx_of(cfg, batch))
        return chunked_ce_loss(params, cfg, x, batch["labels"])

    def prefill(params, batch, absorb_mla=False):
        x = common.embed(params["embed"], cfg, batch["tokens"])
        x, caches = decoder.decoder_stack(params, cfg, x, mode="prefill",
                                          ctx=_ctx_of(cfg, batch),
                                          absorb_mla=absorb_mla)
        logits = common.unembed(params["embed"], cfg, x[:, -1:, :])
        return logits[:, 0, :], caches

    def decode(params, caches, batch, absorb_mla=False):
        x = common.embed(params["embed"], cfg, batch["token"])
        x, caches = decoder.decoder_stack(params, cfg, x, mode="decode",
                                          caches=caches, pos=batch["pos"],
                                          ctx=None, absorb_mla=absorb_mla)
        logits = common.unembed(params["embed"], cfg, x)
        return logits[:, 0, :], caches

    def init_cache(batch_size, buf_len, ctx_len=None, device=device):
        del ctx_len  # vlm ctx length is fixed by the vision stub
        n_ctx = cfg.vision.n_vision_tokens if cfg.vision else 0
        return decoder.init_decoder_cache(cfg, batch_size, buf_len, n_ctx,
                                          device)

    def input_specs(shape: ShapeCell):
        B, S = shape.global_batch, shape.seq_len
        tok = _meta((B, S), torch.int32)
        if shape.kind == "train":
            batch = {"tokens": tok, "labels": tok}
        elif shape.kind == "prefill":
            batch = {"tokens": tok}
        else:
            batch = {"token": _meta((B, 1), torch.int32),
                     "pos": _meta((), torch.int32)}
        if cfg.family == "vlm" and shape.kind in ("train", "prefill"):
            batch["vision_embeds"] = _meta(
                (B, cfg.vision.n_vision_tokens, cfg.d_model),
                common.dtype_of(cfg))
        return batch

    return _model(cfg, device, init_params, train_loss, prefill, decode,
                  init_cache, input_specs)


# ----------------------------------------------------------------------------
# encoder-decoder family (seamless-m4t): stubbed audio frontend


def _build_encdec_model(cfg: ModelConfig, device: torch.device) -> Model:
    def init_params(generator):
        params = decoder.init_decoder(generator, cfg, device)
        params["encoder"] = decoder.init_encoder(generator, cfg, device)
        return params

    def train_loss(params, batch):
        enc = decoder.encoder_stack(params["encoder"], cfg,
                                    batch["audio_embeds"], remat=cfg.remat)
        x = common.embed(params["embed"], cfg, batch["tokens"])
        x, _ = decoder.decoder_stack(params, cfg, x, mode="train", ctx=enc)
        return chunked_ce_loss(params, cfg, x, batch["labels"])

    def prefill(params, batch):
        enc = decoder.encoder_stack(params["encoder"], cfg,
                                    batch["audio_embeds"])
        x = common.embed(params["embed"], cfg, batch["tokens"])
        x, caches = decoder.decoder_stack(params, cfg, x, mode="prefill",
                                          ctx=enc)
        logits = common.unembed(params["embed"], cfg, x[:, -1:, :])
        return logits[:, 0, :], caches

    def decode(params, caches, batch):
        x = common.embed(params["embed"], cfg, batch["token"])
        x, caches = decoder.decoder_stack(params, cfg, x, mode="decode",
                                          caches=caches, pos=batch["pos"],
                                          ctx=None)
        logits = common.unembed(params["embed"], cfg, x)
        return logits[:, 0, :], caches

    def init_cache(batch_size, buf_len, ctx_len=None, device=device):
        # ctx_len = the encoded source length (buf_len when None, as in JAX)
        return decoder.init_decoder_cache(
            cfg, batch_size, buf_len,
            ctx_len if ctx_len is not None else buf_len, device)

    def input_specs(shape: ShapeCell):
        B, S = shape.global_batch, shape.seq_len
        tok = _meta((B, S), torch.int32)
        audio = _meta((B, S, cfg.d_model), common.dtype_of(cfg))
        if shape.kind == "train":
            return {"tokens": tok, "labels": tok, "audio_embeds": audio}
        if shape.kind == "prefill":
            return {"tokens": tok, "audio_embeds": audio}
        return {"token": _meta((B, 1), torch.int32),
                "pos": _meta((), torch.int32)}

    return _model(cfg, device, init_params, train_loss, prefill, decode,
                  init_cache, input_specs)


def build_model(arch_or_cfg, device=None) -> Model:
    """The model on the card, on the CPU (``device="cpu"``) or on the meta
    device (``device="meta"``: shape-only trees that nothing computes on;
    ``resolve_device``, which every entry point goes through, refuses it)."""
    cfg = (arch_or_cfg if isinstance(arch_or_cfg, ModelConfig)
           else get_config(arch_or_cfg))
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    if cfg.family == "audio":
        return _build_encdec_model(cfg, dev)
    return _build_decoder_model(cfg, dev)
