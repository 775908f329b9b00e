# Port of repro/models/decoder.py: the grouped decoder stack on torch (kinds "dense", "moe" and "rwkv").
"""Generic grouped decoder stack.

Layers are described by a per-layer ``LayerSpec``; consecutive identical
specs form a ``Group`` whose params carry a leading ``n`` (layer) dimension,
the same stacking as the JAX package, so its params map key for key.  Where
JAX scans a group with ``lax.scan``, the port loops over its layers.

The port runs kinds ``"dense"``, ``"moe"`` and ``"rwkv"`` in prefill and
decode.  The other kinds (hymba, cross, encdec_dec), MLA and
``mode="train"`` raise ``NotImplementedError`` naming the slice they wait
for.  The JAX stack's ``constrain_seq`` is a no-op off a device mesh and
waits for the sharding slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, layers
from repro_torch.models.common import rms_norm

# kinds: dense | moe | rwkv | hymba | cross | encdec_dec

_LATER = {
    "hymba": "the Mamba/hymba slice",
    "cross": "the cross-attention/VLM slice",
    "encdec_dec": "the encoder-decoder slice",
}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str
    window: Optional[int] = None
    mla: bool = False


@dataclasses.dataclass(frozen=True)
class Group:
    spec: LayerSpec
    n: int


def build_layout(cfg: ModelConfig) -> list[Group]:
    specs: list[LayerSpec] = []
    for i in range(cfg.n_layers):
        window = cfg.sliding_window
        if cfg.global_layers and i in cfg.global_layers:
            window = None
        if cfg.family == "ssm":
            specs.append(LayerSpec("rwkv"))
        elif cfg.family == "hybrid":
            specs.append(LayerSpec("hymba", window=window))
        elif cfg.family == "audio":
            specs.append(LayerSpec("encdec_dec"))
        elif cfg.family == "vlm" and cfg.vision and (
                i % cfg.vision.cross_attn_every == cfg.vision.cross_attn_every - 2):
            # cross layers at 3, 8, 13, ... for every=5
            specs.append(LayerSpec("cross"))
        elif cfg.moe is not None:
            specs.append(LayerSpec("moe", window=window, mla=cfg.mla is not None))
        else:
            specs.append(LayerSpec("dense", window=window))
    groups: list[Group] = []
    for s in specs:
        if groups and groups[-1].spec == s:
            groups[-1] = Group(s, groups[-1].n + 1)
        else:
            groups.append(Group(s, 1))
    return groups


def _check_ported(spec: LayerSpec):
    if spec.kind in _LATER:
        raise NotImplementedError(
            f"layer kind {spec.kind!r} waits for {_LATER[spec.kind]}")
    if spec.mla:
        raise NotImplementedError("MLA attention waits for the MLA slice")


# ----------------------------------------------------------------------------
# per-group init / forward (kinds "dense", "moe" and "rwkv")


def _init_group(generator, cfg: ModelConfig, g: Group, dtype, device):
    _check_ported(g.spec)
    D, lead = cfg.d_model, (g.n,)
    if g.spec.kind == "rwkv":
        return {"ln1": torch.zeros(lead + (D,), dtype=dtype, device=device),
                **layers.init_rwkv_layer(generator, cfg, dtype, device, lead),
                "ln2": torch.zeros(lead + (D,), dtype=dtype, device=device)}
    p = {
        "ln1": torch.zeros(lead + (D,), dtype=dtype, device=device),
        "attn": layers.init_attention(generator, cfg, dtype, device, lead),
        "ln2": torch.zeros(lead + (D,), dtype=dtype, device=device),
    }
    if g.spec.kind == "moe":     # the router stays f32 (init_moe)
        p["moe"] = layers.init_moe(generator, cfg, dtype, device, lead)
    else:
        p["mlp"] = common.init_mlp(generator, D, cfg.d_ff, dtype, device,
                                   lead)
    return p


def _init_group_cache(cfg: ModelConfig, g: Group, batch, buf_len, dtype,
                      device):
    _check_ported(g.spec)
    if g.spec.kind == "rwkv":
        return layers.init_rwkv_cache(cfg, batch, dtype, device, (g.n,))
    buf = min(buf_len, g.spec.window) if g.spec.window else buf_len
    return layers.init_attn_cache(cfg, batch, buf, dtype, device, (g.n,))


def _layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x, *, mode, cache,
                   pos):
    if spec.kind == "rwkv":
        cache = cache or {}
        h, tm_cache = layers.rwkv_time_mix(
            p, cfg, rms_norm(x, p["ln1"], cfg.norm_eps), mode=mode,
            cache=cache)
        x = x + h
        h, cm_shift = layers.rwkv_channel_mix(
            p, cfg, rms_norm(x, p["ln2"], cfg.norm_eps), mode=mode,
            cache=cache.get("cm_shift"))
        return x + h, dict(tm_cache, cm_shift=cm_shift)
    xin = rms_norm(x, p["ln1"], cfg.norm_eps)
    h, a_cache = layers.attn_sublayer(p["attn"], cfg, xin, mode=mode,
                                      cache=cache, pos=pos,
                                      window=spec.window)
    x = x + h
    xin = rms_norm(x, p["ln2"], cfg.norm_eps)
    if spec.kind == "moe":
        return x + layers.moe_ffn(p["moe"], cfg, xin), a_cache
    return x + common.mlp(p["mlp"], xin, cfg.act), a_cache


# ----------------------------------------------------------------------------
# decoder-level init / forward


def init_decoder(generator, cfg: ModelConfig, device=None):
    dtype = common.dtype_of(cfg)
    return {"embed": common.init_embedding(generator, cfg, dtype, device),
            "groups": [_init_group(generator, cfg, g, dtype, device)
                       for g in build_layout(cfg)]}


def init_decoder_cache(cfg: ModelConfig, batch, buf_len, ctx_len=0,
                       device=None):
    del ctx_len  # cross-attention caches wait for their slice
    dtype = common.dtype_of(cfg)
    return [_init_group_cache(cfg, g, batch, buf_len, dtype, device)
            for g in build_layout(cfg)]


def decoder_stack(params, cfg: ModelConfig, x, *, mode, caches=None, pos=None,
                  ctx=None):
    """Run all layer groups.  x: [B, S, D] -> ([B, S, D], new_caches).

    Prefill produces each group's cache stacked over its layers; decode
    writes into ``caches`` in place and returns them."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(
            f"mode {mode!r}: training waits for the training slice")
    if ctx is not None:
        raise NotImplementedError("a context input (cross-attention) waits "
                                  "for the cross-attention/VLM slice")
    groups = build_layout(cfg)
    caches = caches if caches is not None else [None] * len(groups)
    new_caches = []
    for g, gparams, gcache in zip(groups, params["groups"], caches):
        _check_ported(g.spec)
        produced = []
        for i in range(g.n):   # layer i of the stacked params and cache
            x, c = _layer_forward(
                tree_map(lambda t: t[i], gparams), cfg, g.spec, x, mode=mode,
                cache=(None if gcache is None
                       else tree_map(lambda t: t[i], gcache)), pos=pos)
            produced.append(c)
        new_caches.append(gcache if gcache is not None else tree_map(
            lambda *ts: torch.stack(ts), *produced))
    return x, new_caches
