# Port of repro/models/decoder.py: the grouped decoder stack and the encoder stack on torch (every layer kind).
"""Generic grouped decoder stack, and the encoder-decoder family's encoder.

Layers are described by a per-layer ``LayerSpec``; consecutive identical
specs form a ``Group`` whose params carry a leading ``n`` (layer) dimension,
the same stacking as the JAX package, so its params map key for key.  Where
JAX scans a group with ``lax.scan``, the port loops over its layers.

The port runs every kind in prefill and decode: ``"dense"``, ``"moe"`` (MLA
attention too, in both ``absorb_mla`` modes), ``"rwkv"``, ``"cross"`` (the
VLM's gated cross-attention layers over a context input), ``"hymba"``
(attention and a Mamba branch side by side on one norm) and ``"encdec_dec"``
(self-attention, ungated cross-attention over the encoder's output, MLP).
``encoder_stack`` is the encoder-decoder family's bidirectional encoder.

``mode="train"`` runs every layer with no cache, each under
``torch.utils.checkpoint`` (non-reentrant) when ``cfg.remat`` is set, the
counterpart of the JAX stack's ``jax.checkpoint(..., nothing_saveable)``:
the backward recomputes a layer's activations from its input (the router
kernel's forward among them, whose picks come out the same; the WKV
scan's forward, which writes the same chunk states).  Every kind trains.
Every layer's input outside decode passes ``constrain_seq``, as in the JAX
stack: on a DTensor under an active mesh it shards the residual stream's
sequence over ``model``, and it is the identity on plain tensors.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch._meta import checkpoint
from repro_torch._tree import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain_seq
from repro_torch.models import common, layers
from repro_torch.models.common import apply_rope, rms_norm

# kinds: dense | moe | rwkv | hymba | cross | encdec_dec


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


# ----------------------------------------------------------------------------
# per-group init / forward


def _init_group(generator, cfg: ModelConfig, g: Group, dtype, device):
    D, lead = cfg.d_model, (g.n,)

    def norm():
        return torch.zeros(lead + (D,), dtype=dtype, device=device)

    if g.spec.kind == "rwkv":
        return {"ln1": norm(),
                **layers.init_rwkv_layer(generator, cfg, dtype, device, lead),
                "ln2": norm()}
    if g.spec.kind == "hymba":   # A_log stays f32 (init_mamba)
        return {"ln1": norm(),
                "attn": layers.init_attention(generator, cfg, dtype, device,
                                              lead),
                "mamba": layers.init_mamba(generator, cfg, dtype, device,
                                           lead),
                "norm_attn": norm(), "norm_ssm": norm(), "ln2": norm(),
                "mlp": common.init_mlp(generator, D, cfg.d_ff, dtype, device,
                                       lead)}
    if g.spec.kind == "encdec_dec":
        return {"ln1": norm(),
                "attn": layers.init_attention(generator, cfg, dtype, device,
                                              lead),
                "ln_cross": norm(),
                "cross": layers.init_cross_attention(generator, cfg, dtype,
                                                     False, device, lead),
                "ln2": norm(),
                "mlp": common.init_mlp(generator, D, cfg.d_ff, dtype, device,
                                       lead)}
    if g.spec.kind == "cross":
        attn = layers.init_cross_attention(generator, cfg, dtype, True,
                                           device, lead)
    elif g.spec.mla:
        attn = layers.init_mla(generator, cfg, dtype, device, lead)
    else:
        attn = layers.init_attention(generator, cfg, dtype, device, lead)
    p = {"ln1": norm(), "attn": attn, "ln2": norm()}
    if g.spec.kind == "moe":     # the router stays f32 (init_moe)
        p["moe"] = layers.init_moe(generator, cfg, dtype, device, lead)
    else:
        p["mlp"] = common.init_mlp(generator, D, cfg.d_ff, dtype, device,
                                   lead)
    return p


def _init_group_cache(cfg: ModelConfig, g: Group, batch, buf_len, ctx_len,
                      dtype, device):
    lead = (g.n,)
    if g.spec.kind == "rwkv":
        return layers.init_rwkv_cache(cfg, batch, dtype, device, lead)
    if g.spec.kind in ("cross", "encdec_dec"):  # cross: sized by the context
        kv = layers.init_attn_cache(cfg, batch, ctx_len, dtype, device, lead)
        cross = {"ck": kv["k"], "cv": kv["v"]}
        if g.spec.kind == "cross":
            return cross
        return {"attn": layers.init_attn_cache(cfg, batch, buf_len, dtype,
                                               device, lead),
                "cross": cross}
    buf = min(buf_len, g.spec.window) if g.spec.window else buf_len
    if g.spec.kind == "hymba":   # a ring of `window` slots on windowed layers
        return {"attn": layers.init_attn_cache(cfg, batch, buf, dtype, device,
                                               lead),
                "mamba": layers.init_mamba_cache(cfg, batch, dtype, device,
                                                 lead)}
    if g.spec.mla:
        return layers.init_mla_cache(cfg, batch, buf, dtype, device, lead)
    return layers.init_attn_cache(cfg, batch, buf, dtype, device, lead)


def _norm_in(x, scale, cfg):
    """A sublayer's input: the normed residual stream, its sequence whole
    where it is a DTensor.  ``constrain_seq`` shards the stream's sequence
    between layers, and the sublayers' products fold batch and sequence
    into one dim, which DTensor's views cannot do with the second dim
    sharded (the all-gather before a block of sequence parallelism)."""
    return common.whole(rms_norm(x, scale, cfg.norm_eps), [1])


def _add(x, h):
    """The residual ``x + h``; on DTensors ``h`` first laid out as ``x``, so
    that the gradient coming back to ``h`` takes ``h``'s own layout (an
    add's backward hands each input the output's, the sequence-sharded
    one, which the sublayer's products would then have to fold)."""
    if isinstance(x, DTensor) and isinstance(h, DTensor):
        h = h.redistribute(x.device_mesh, x.placements)
    return x + h


def _layer_forward(p, cfg: ModelConfig, spec: LayerSpec, x, *, mode, cache,
                   pos, ctx=None, absorb_mla=False):
    if spec.kind == "rwkv":
        cache = cache or {}
        h, tm_cache = layers.rwkv_time_mix(
            p, cfg, _norm_in(x, p["ln1"], cfg), mode=mode,
            cache=cache)
        x = _add(x, h)
        h, cm_shift = layers.rwkv_channel_mix(
            p, cfg, _norm_in(x, p["ln2"], cfg), mode=mode,
            cache=cache.get("cm_shift"))
        if mode == "train":
            return _add(x, h), None
        return _add(x, h), dict(tm_cache, cm_shift=cm_shift)
    if spec.kind == "cross":      # residuals gated by tanh(gate)
        h, c_cache = layers.cross_sublayer(
            p["attn"], cfg, _norm_in(x, p["ln1"], cfg), mode=mode,
            cache=cache, ctx=ctx)
        x = _add(x, torch.tanh(p["attn"]["gate_attn"]) * h)
        h = common.mlp(p["mlp"], _norm_in(x, p["ln2"], cfg), cfg.act)
        return _add(x, torch.tanh(p["attn"]["gate_ffn"]) * h), c_cache
    if spec.kind == "hymba":      # attention and Mamba on one norm
        cache = cache or {}
        xin = _norm_in(x, p["ln1"], cfg)
        a, a_cache = layers.attn_sublayer(
            p["attn"], cfg, xin, mode=mode, cache=cache.get("attn"), pos=pos,
            window=spec.window)
        s, s_cache = layers.mamba_branch(p["mamba"], cfg, xin, mode=mode,
                                         cache=cache.get("mamba"))
        x = _add(x, 0.5 * (rms_norm(a, p["norm_attn"], cfg.norm_eps)
                           + rms_norm(s, p["norm_ssm"], cfg.norm_eps)))
        h = common.mlp(p["mlp"], _norm_in(x, p["ln2"], cfg), cfg.act)
        return _add(x, h), {"attn": a_cache, "mamba": s_cache}
    if spec.kind == "encdec_dec":  # self, ungated cross over ctx, MLP
        cache = cache or {}
        h, a_cache = layers.attn_sublayer(
            p["attn"], cfg, _norm_in(x, p["ln1"], cfg), mode=mode,
            cache=cache.get("attn"), pos=pos, window=None)
        x = _add(x, h)
        h, c_cache = layers.cross_sublayer(
            p["cross"], cfg, _norm_in(x, p["ln_cross"], cfg),
            mode=mode, cache=cache.get("cross"), ctx=ctx)
        x = _add(x, h)
        h = common.mlp(p["mlp"], _norm_in(x, p["ln2"], cfg), cfg.act)
        return _add(x, h), {"attn": a_cache, "cross": c_cache}
    xin = _norm_in(x, p["ln1"], cfg)
    if spec.mla:
        h, a_cache = layers.mla_sublayer(p["attn"], cfg, xin, mode=mode,
                                         cache=cache, pos=pos,
                                         absorb=absorb_mla)
    else:
        h, a_cache = layers.attn_sublayer(p["attn"], cfg, xin, mode=mode,
                                          cache=cache, pos=pos,
                                          window=spec.window)
    x = _add(x, h)
    xin = _norm_in(x, p["ln2"], cfg)
    if spec.kind == "moe":
        return _add(x, layers.moe_ffn(p["moe"], cfg, xin)), a_cache
    return _add(x, common.mlp(p["mlp"], xin, cfg.act)), a_cache


# ----------------------------------------------------------------------------
# decoder-level init / forward


def init_decoder(generator, cfg: ModelConfig, device=None):
    dtype = common.dtype_of(cfg)
    return {"embed": common.init_embedding(generator, cfg, dtype, device),
            "groups": [_init_group(generator, cfg, g, dtype, device)
                       for g in build_layout(cfg)]}


def init_decoder_cache(cfg: ModelConfig, batch, buf_len, ctx_len=0,
                       device=None):
    dtype = common.dtype_of(cfg)
    return [_init_group_cache(cfg, g, batch, buf_len, ctx_len, dtype, device)
            for g in build_layout(cfg)]


def _train_layer(p, cfg, spec, ctx, x):
    x = constrain_seq(x)   # sequence-parallel residual stream (off-mesh: x)
    return _layer_forward(p, cfg, spec, x, mode="train", cache=None,
                          pos=None, ctx=ctx)[0]


def decoder_stack(params, cfg: ModelConfig, x, *, mode, caches=None, pos=None,
                  ctx=None, absorb_mla=False):
    """Run all layer groups.  x: [B, S, D] -> ([B, S, D], new_caches); a
    DTensor x comes back with its sequence whole.

    Train runs each layer with no cache (under ``checkpoint`` with
    ``cfg.remat``) and returns None for each group's cache.  Prefill
    produces each group's cache stacked over its layers (a cross layer's
    from ``ctx``); decode writes into ``caches`` in place and returns them
    (a cross layer reads its cache, and ``ctx`` is None)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    groups = build_layout(cfg)
    if mode == "train":
        for g, gparams in zip(groups, params["groups"]):
            for i in range(g.n):
                layer = partial(_train_layer, tree_map(lambda t: t[i],
                                                       gparams),
                                cfg, g.spec, ctx)
                x = checkpoint(layer, x) if cfg.remat else layer(x)
        return common.whole(x, [1]), [None] * len(groups)
    caches = caches if caches is not None else [None] * len(groups)
    new_caches = []
    for g, gparams, gcache in zip(groups, params["groups"], caches):
        produced = []
        for i in range(g.n):   # layer i of the stacked params and cache
            if mode != "decode":
                x = constrain_seq(x)
            x, c = _layer_forward(
                tree_map(lambda t: t[i], gparams), cfg, g.spec, x, mode=mode,
                cache=(None if gcache is None
                       else tree_map(lambda t: t[i], gcache)), pos=pos,
                ctx=ctx, absorb_mla=absorb_mla)
            produced.append(c)
        new_caches.append(gcache if gcache is not None else tree_map(
            lambda *ts: torch.stack(ts), *produced))
    return common.whole(x, [1]), new_caches


# ----------------------------------------------------------------------------
# encoder stack (seamless-m4t): bidirectional, no cache


def init_encoder(generator, cfg: ModelConfig, device=None):
    dtype = common.dtype_of(cfg)
    g = Group(LayerSpec("dense"), cfg.encdec.n_enc_layers)
    return {"layers": _init_group(generator, cfg, g, dtype, device),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=device)}


def _encoder_layer(lp, cfg, cos, sin, x):
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    attn = lp["attn"]
    xin = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = apply_rope(layers._project(xin, attn["wq"]), cos, sin)
    k = apply_rope(layers._project(xin, attn["wk"]), cos, sin)
    v = layers._project(xin, attn["wv"])
    out = common.attention(cfg, q, k, v, causal=False)
    x = x + out.reshape(B, S, H * hd) @ attn["wo"].reshape(H * hd, D)
    return x + common.mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps),
                          cfg.act)


def encoder_stack(params, cfg: ModelConfig, x, *, remat=False):
    """Bidirectional encoder over stubbed frame embeddings [B, S, D].

    ``attn_sublayer`` is causal, so a non-causal variant is inlined here,
    as in the JAX encoder; its attention is prefill-shaped (Sq == Sk), so
    ``common.attention`` sends it to the flash kernel, non-causal.
    ``remat``: each layer under ``checkpoint`` (training)."""
    cos, sin = rope_freqs_cached(cfg, torch.arange(x.shape[1],
                                                   device=x.device))
    for i in range(cfg.encdec.n_enc_layers):
        layer = partial(_encoder_layer,
                        tree_map(lambda t: t[i], params["layers"]), cfg, cos,
                        sin)
        x = checkpoint(layer, x) if remat else layer(x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def rope_freqs_cached(cfg, positions):
    return common.rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
