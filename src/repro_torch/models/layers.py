# Port of repro/models/layers.py: the GQA self-attention, cross-attention, MLA, MoE FFN, RWKV6 and Mamba sublayers on torch; the MoE router and the WKV recurrence run on CUDA kernels.
"""The GQA self-attention sublayer (dense, MoE, VLM, hymba and decoder self
layers), with its KV cache; the cross-attention sublayer (the VLM's gated
image layers, the encoder-decoder's ungated ones); MLA, multi-head latent
attention (deepseek-v2), with its latent cache; the MoE FFN (GShard-style
capacity dispatch); the RWKV6 (Finch) time- and channel-mix sublayers, with
their recurrent cache; and the Mamba selective-SSM branch of hymba's layers,
with its conv and state cache.

    init_attention(generator, cfg, dtype) -> params
    attn_sublayer(params, cfg, x, *, mode, cache, pos, window) -> (y, cache)
    init_cross_attention(generator, cfg, dtype, gated) -> params
    cross_sublayer(params, cfg, x, *, mode, cache, ctx) -> (y, {"ck", "cv"})
    init_mla(generator, cfg, dtype) -> params
    mla_sublayer(params, cfg, x, *, mode, cache, pos, absorb) -> (y, cache)
    init_moe(generator, cfg, dtype) -> {"router" (f32), "wi", "wg", "wo"}
    moe_ffn(params, cfg, x) -> y
    init_rwkv_layer(generator, cfg, dtype) -> {"tm", "cm"}
    rwkv_time_mix(params, cfg, x, *, mode, cache) -> (y, {"state", "tm_shift"})
    rwkv_channel_mix(params, cfg, x, *, mode, cache) -> (y, cm_shift)
    init_mamba(generator, cfg, dtype) -> params (``A_log`` f32)
    mamba_branch(params, cfg, x, *, mode, cache) -> (y, {"conv", "ssm"})

``mode``: "train" | "prefill" | "decode".  "train" runs the full sequence
with no cache, as prefill does, and returns None for the cache; every
sublayer trains (the flash, router and WKV-scan kernels have backwards;
MLA's attention is the XLA-path ports, which autograd differentiates; the
Mamba recurrence runs under ``common.chunked_time_scan``);
``cache``: {"k", "v"} [B, buf, K, hd] (None in prefill), the cross cache
{"ck", "cv"} [B, S_ctx, K, hd], the MLA latent cache {"ckv" [B, buf, R],
"krope" [B, buf, rope]}, or the RWKV cache {"state" [B, H, hd, hd] f32,
"tm_shift", "cm_shift" [B, D]}, or the Mamba cache {"conv" [B, d_conv - 1,
d_inner], "ssm" [B, d_inner, N] f32}; ``pos``: int, the absolute position
of the incoming token (decode); ``ctx``: the vision context or the encoded
audio [B, S_ctx, D] (prefill; decode reads the cross cache instead).

Caches are written in place in decode (where JAX returns updated buffers):
the attention and latent caches at the token's slot, the RWKV state by the
``rwkv_scan`` kernel itself (``state_out=state``) and the two token shifts
by a copy, the Mamba conv history and state by a copy; the cross cache is
read, never written.  The WKV recurrence, which the JAX layer runs as
``common.chunked_time_scan`` (a remat device for training), runs on
``kernels.rwkv_scan``; in training its forward kernel saves the state
before every 64th step and its backward kernel recomputes each chunk from
it, the same O(S / 64) states that scan keeps.  The MoE router (the JAX
``_route``/``_route_grouped``: logits, softmax, top-k mask and renormalized
gates) runs on ``kernels.moe_routing``; the expert products stay
``torch.einsum``, plain large products that the JAX package leaves to XLA.
MLA attention takes the XLA-path ports of ``common.attention`` (its shapes
do not fit the attention kernels), and so does cross-attention except in a
prefill whose context is as long as the query (the encoder-decoder's, where
``common.attention`` routes it to the flash kernel, non-causal).  The Mamba
recurrence is ``lax.scan`` in the JAX package, not a Pallas kernel, so the
port runs it in PyTorch on tensors: ``selective_scan`` in prefill and
decode, ``common.chunked_time_scan`` of ``mamba_step`` in training.  The JAX
package's ``ONEHOT_CACHE_UPDATE`` switch is ported (off by default, as
there); ``moe_ffn`` calls the MoE sharding constraints where the JAX one
does (``constrain_moe_groups``, ``constrain_moe_expert``: the identity on
plain tensors).  The ``SHARDED_DECODE_ATTN`` switch (a ``shard_map``
flash-decode) waits for a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain_moe_expert,
                                              constrain_moe_groups,
                                              local_offset, local_part)
from repro_torch.kernels.moe_routing import moe_routing
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.models import common
from repro_torch.models.common import (apply_rope, attention, dense_init,
                                       head_rms_norm, rms_norm, rope_freqs)


# When True, decode-cache writes use a one-hot masked update instead of the
# slot write: elementwise, so it stays shard-local on a sequence-sharded
# cache (the JAX package's switch; its baseline is the slot write).
ONEHOT_CACHE_UPDATE = False


def _cache_write(buf, update, idx):
    """Write ``update`` [B, 1, ...] into ``buf`` [B, S, ...] at ``idx``, in
    place; ``idx`` is clamped into the buffer as ``dynamic_update_slice``
    clamps it.  With ``ONEHOT_CACHE_UPDATE`` the buffer becomes
    ``buf * (1 - onehot) + update * onehot``, written back into it (an
    ``idx`` outside the buffer then writes nothing, as in JAX)."""
    if ONEHOT_CACHE_UPDATE:
        S = buf.shape[1]
        onehot = (torch.arange(S, dtype=torch.int32, device=buf.device)
                  == int(idx)).to(buf.dtype)
        onehot = onehot.reshape((1, S) + (1,) * (buf.dim() - 2))
        buf.copy_(buf * (1 - onehot) + update.to(buf.dtype) * onehot)
        return buf
    idx = min(max(int(idx), 0), buf.shape[1] - 1)
    if isinstance(buf, DTensor):
        return _slot_write_sharded(buf, update, idx)
    buf[:, idx] = update[:, 0]
    return buf


def _slot_write_sharded(buf, update, idx):
    """The slot write on a DTensor cache, on each rank's own shard: the
    rank whose shard of dim 1 holds slot ``idx`` writes it, with the update
    laid out as the buffer's other dims.  (DTensor's indexed write would
    redistribute the sharded slot dim into a copy and write that.)"""
    upd = local_part(update, buf, {1})   # a collective: on every rank
    local = buf.to_local()
    i = idx - local_offset(buf, 1)
    if 0 <= i < local.shape[1]:
        local[:, i] = upd[:, 0]
    return buf


def init_attention(generator, cfg: ModelConfig, dtype, device=None, lead=()):
    H, K, hd, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "wq": dense_init(generator, (D, H, hd), in_axis=0, **kw),
        "wk": dense_init(generator, (D, K, hd), in_axis=0, **kw),
        "wv": dense_init(generator, (D, K, hd), in_axis=0, **kw),
        "wo": dense_init(generator, (H, hd, D), in_axis=-1, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(tuple(lead) + (hd,), dtype=dtype,
                                  device=device)
        p["k_norm"] = torch.zeros(tuple(lead) + (hd,), dtype=dtype,
                                  device=device)
    return p


def init_attn_cache(cfg: ModelConfig, batch, buf_len, dtype, device=None,
                    lead=()):
    shape = tuple(lead) + (batch, buf_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project(x, w):
    """x [B, S, D] @ w [D, N, hd] -> [B, S, N, hd], contiguous."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])


def attn_sublayer(p, cfg: ModelConfig, x, *, mode, cache, pos, window):
    """x: [B, S, D].  Ring-buffer cache when ``window`` is set."""
    B, S, D = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, p["k_norm"], cfg.norm_eps)

    if mode == "decode":
        positions = torch.full((S,), int(pos), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    cos, sin = rope_freqs(cfg.head_dim, cfg.rope_theta, positions)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if mode in ("train", "prefill"):
        out = attention(cfg, q, k, v, causal=True, window=window)
        if mode == "train":
            new_cache = None
        elif window is not None:
            # ring buffer holding the last `window` tokens
            new_cache = {"k": k[:, -window:], "v": v[:, -window:]}
        else:
            new_cache = {"k": k, "v": v}
    elif mode == "decode":  # write one token, attend over the cache
        buf = cache["k"].shape[1]
        idx = pos % window if window is not None else pos
        ck = _cache_write(cache["k"], k, idx)
        cv = _cache_write(cache["v"], v, idx)
        new_cache = {"k": ck, "v": cv}
        # every slot of the ring is within the window once warm; a validity
        # bound covers the cold start
        k_valid = min(pos + 1, buf) if window is not None else pos + 1
        out = attention(cfg, q, ck, cv, causal=False, window=None,
                        k_valid=k_valid)
    else:
        raise ValueError(f"mode {mode!r}")
    H, hd = cfg.n_heads, cfg.head_dim
    y = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return y, new_cache


# =============================================================================
# Cross-attention sublayer (the VLM's image layers)
# =============================================================================


def init_cross_attention(generator, cfg: ModelConfig, dtype, gated: bool,
                         device=None, lead=()):
    p = init_attention(generator, cfg, dtype, device, lead)
    if gated:  # llama-3.2-vision style tanh gates, 0 at init
        p["gate_attn"] = torch.zeros(tuple(lead), dtype=dtype, device=device)
        p["gate_ffn"] = torch.zeros(tuple(lead), dtype=dtype, device=device)
    return p


def cross_sublayer(p, cfg: ModelConfig, x, *, mode, cache, ctx):
    """Cross-attention: queries from x, keys and values from ``ctx``.
    Prefill computes them from ``ctx`` and returns them as the cache (train
    computes them too and returns None); decode reads them from the cache
    (``ctx`` is static across steps)."""
    B, S, D = x.shape
    q = _project(x, p["wq"])
    if cfg.qk_norm:
        q = head_rms_norm(q, p["q_norm"], cfg.norm_eps)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if mode == "decode" and cache is not None:
        ck, cv = cache["ck"], cache["cv"]
        new_cache = cache
    else:
        ck = _project(ctx, p["wk"])
        cv = _project(ctx, p["wv"])
        if cfg.qk_norm:
            ck = head_rms_norm(ck, p["k_norm"], cfg.norm_eps)
        new_cache = {"ck": ck, "cv": cv} if mode != "train" else None
    out = attention(cfg, q, ck, cv, causal=False, window=None)
    H, hd = cfg.n_heads, cfg.head_dim
    return out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D), new_cache


# =============================================================================
# MLA: multi-head latent attention (deepseek-v2)
# =============================================================================


def init_mla(generator, cfg: ModelConfig, dtype, device=None, lead=()):
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)

    def zeros(n):
        return torch.zeros(tuple(lead) + (n,), dtype=dtype, device=device)

    return {
        "wq_a": dense_init(generator, (D, m.q_lora_rank), in_axis=0, **kw),
        "q_norm": zeros(m.q_lora_rank),
        "wq_b": dense_init(generator, (m.q_lora_rank, H, qk_hd), in_axis=0,
                           **kw),
        "wkv_a": dense_init(generator,
                            (D, m.kv_lora_rank + m.qk_rope_head_dim),
                            in_axis=0, **kw),
        "kv_norm": zeros(m.kv_lora_rank),
        "wk_b": dense_init(generator, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                           in_axis=0, **kw),
        "wv_b": dense_init(generator, (m.kv_lora_rank, H, m.v_head_dim),
                           in_axis=0, **kw),
        "wo": dense_init(generator, (H, m.v_head_dim, D), in_axis=-1, **kw),
    }


def init_mla_cache(cfg: ModelConfig, batch, buf_len, dtype, device=None,
                   lead=()):
    m = cfg.mla
    shape = tuple(lead) + (batch, buf_len)
    return {"ckv": torch.zeros(shape + (m.kv_lora_rank,), dtype=dtype,
                               device=device),
            "krope": torch.zeros(shape + (m.qk_rope_head_dim,), dtype=dtype,
                                 device=device)}


def mla_sublayer(p, cfg: ModelConfig, x, *, mode, cache, pos,
                 absorb: bool = False):
    """MLA with a compressed latent cache.

    ``absorb=False`` (the paper-faithful baseline): decode re-expands k and
    v from the whole latent buffer through wk_b and wv_b each step.
    ``absorb=True``: wk_b is folded into the query and wv_b into the output
    projection, so decode attends in the rank-R latent space as MQA (q and
    k of R + rope dims, v of R).  As in the JAX layer, the scores are then
    divided by sqrt(R + rope), q's width there, not sqrt(nope + rope): the
    two modes are not the same function.  "train" is prefill with no
    cache."""
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    R = m.kv_lora_rank

    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = _project(q, p["wq_b"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv_a = x @ p["wkv_a"]
    ckv = rms_norm(kv_a[..., :R], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., R:]

    if mode == "decode":
        positions = torch.full((S,), int(pos), dtype=torch.int32,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device)
    cos, sin = rope_freqs(rope_d, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    # k_rope is one head shared by all query heads
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]

    if mode == "decode":
        ckv_full = _cache_write(cache["ckv"], ckv, pos)
        krope_full = _cache_write(cache["krope"], k_rope, pos)
        new_cache = {"ckv": ckv_full, "krope": krope_full}
        k_valid, causal = pos + 1, False
    elif mode in ("train", "prefill"):
        ckv_full, krope_full = ckv, k_rope
        new_cache = ({"ckv": ckv, "krope": k_rope} if mode == "prefill"
                     else None)
        k_valid, causal = None, True
    else:
        raise ValueError(f"mode {mode!r}")

    if absorb and mode == "decode":
        # fold wk_b into q: q_lat [B, 1, H, R]; attend in the latent space
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
        q_cat = torch.cat([q_lat, q_rope], dim=-1)
        k_cat = torch.cat([ckv_full, krope_full],
                          dim=-1)[:, :, None, :]     # MQA: one kv head
        out_lat = attention(cfg, q_cat, k_cat, ckv_full[:, :, None, :],
                            causal=False, k_valid=k_valid)
        # out in the latent space, expanded through wv_b, then wo (the JAX
        # "bshr,rhv,hvd->bsd", contracted pairwise in that order)
        out = torch.einsum("bshr,rhv->bshv", out_lat, p["wv_b"])
        return out.reshape(B, S, H * vd) @ p["wo"].reshape(H * vd, D), \
            new_cache

    Sk = ckv_full.shape[1]
    k_nope = _project(ckv_full, p["wk_b"])
    v = _project(ckv_full, p["wv_b"])
    k = torch.cat([k_nope, krope_full[:, :, None, :].expand(B, Sk, H,
                                                            rope_d)], dim=-1)
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    out = attention(cfg, q_cat, k, v, causal=causal, k_valid=k_valid)
    return out.reshape(B, S, H * vd) @ p["wo"].reshape(H * vd, D), new_cache


# =============================================================================
# MoE FFN: GShard-style capacity dispatch, in groups of tokens
# =============================================================================

MOE_CHUNK = 256  # tokens per dispatch group


def init_moe(generator, cfg: ModelConfig, dtype, device=None, lead=()):
    e = cfg.moe
    ff = e.d_ff_expert or cfg.d_ff
    D = cfg.d_model
    kw = dict(device=device, lead=lead)
    p = {
        "router": dense_init(generator, (D, e.n_experts), in_axis=0,
                             dtype=torch.float32, **kw),
        "wi": dense_init(generator, (e.n_experts, D, ff), in_axis=1,
                         dtype=dtype, **kw),
        "wg": dense_init(generator, (e.n_experts, D, ff), in_axis=1,
                         dtype=dtype, **kw),
        "wo": dense_init(generator, (e.n_experts, ff, D), in_axis=-1,
                         dtype=dtype, **kw),
    }
    if e.n_shared:
        p["shared"] = common.init_mlp(generator, D, e.n_shared * ff, dtype,
                                      device, lead)
    return p


def _route(p, cfg: ModelConfig, xf):
    """xf: [T, D] -> (gates [T, E] f32 with zeros off top-k, mask [T, E])."""
    return moe_routing(xf.contiguous(), p["router"], cfg.moe.top_k)


def _route_grouped(p, cfg: ModelConfig, xg):
    """xg: [B, G, T, D] -> (gates, mask) [B, G, T, E] f32."""
    gates, mask = _route(p, cfg, xg.reshape(-1, xg.shape[-1]))
    shape = tuple(xg.shape[:-1]) + (gates.shape[-1],)
    return gates.view(shape), mask.view(shape)


def moe_ffn(p, cfg: ModelConfig, x):
    """GShard grouped capacity dispatch, as the JAX ``moe_ffn``: the
    sequence is split into groups of ``MOE_CHUNK`` tokens (the whole
    sequence where it does not divide), each group dispatches into
    per-expert capacity buffers through dense one-hot einsums, and a token
    past its expert's capacity is dropped.  A slot index of -1 or >=
    capacity one-hots to a zero row, as ``jax.nn.one_hot`` makes it."""
    e = cfg.moe
    B, S, D = x.shape
    g = min(MOE_CHUNK, S)
    if S % g:
        g = S
    G = S // g
    capacity = max(e.top_k, int(g / e.n_experts * e.top_k
                                * e.capacity_factor))
    xg = constrain_moe_groups(x.reshape(B, G, g, D))
    # on DTensors the products below fold (b, g): G whole for them (a
    # view cannot fold a sharded second dim)
    xg = common.whole(xg, [1])
    gates, mask = _route_grouped(p, cfg, xg)
    # position of each token within its expert's capacity buffer (per group)
    pos_in_exp = torch.cumsum(mask, dim=2) - 1.0
    keep = mask * (pos_in_exp < capacity)
    slots = torch.arange(capacity, dtype=torch.int32, device=x.device)
    dispatch = keep[..., None] * (
        pos_in_exp.to(torch.int32)[..., None] == slots)    # [B,G,T,E,C]
    combine = dispatch * gates[..., None]
    dt = x.dtype
    exp_in = constrain_moe_expert(
        torch.einsum("bgtec,bgtd->bgecd", dispatch.to(dt), xg))
    a = torch.einsum("bgecd,edf->bgecf", exp_in, p["wi"])
    h = torch.einsum("bgecd,edf->bgecf", exp_in, p["wg"])
    act = F.gelu(h, approximate="tanh") if cfg.act == "gelu" else F.silu(h)
    exp_out = constrain_moe_expert(
        torch.einsum("bgecf,efd->bgecd", a * act, p["wo"]))
    # on DTensors the combine folds e: E whole for it
    out = torch.einsum("bgtec,bgecd->bgtd", combine.to(dt),
                       common.whole(exp_out, [2]))
    out = constrain_moe_groups(out.reshape(B, G, g, D)).reshape(B, S, D)
    if e.n_shared:
        out = out + common.mlp(p["shared"], x, cfg.act)
    return out


# =============================================================================
# RWKV6 (Finch): time-mix with data-dependent decay + channel-mix
# =============================================================================


def init_rwkv_layer(generator, cfg: ModelConfig, dtype, device=None,
                    lead=()):
    s = cfg.ssm
    D, R = cfg.d_model, s.lora_rank
    kw = dict(dtype=dtype, device=device, lead=lead)

    def full(value, shape):
        return torch.full(tuple(lead) + shape, value, dtype=dtype,
                          device=device)

    tm = {f"mu_{nm}": full(0.0, (D,)) for nm in ["x", "r", "k", "v", "w",
                                                 "g"]}
    for nm in ["r", "k", "v", "w", "g"]:
        tm[f"lora_{nm}_a"] = dense_init(generator, (D, R), in_axis=0, **kw)
        tm[f"lora_{nm}_b"] = full(0.0, (R, D))
    tm["w0"] = full(-1.0, (D,))                  # decay base
    tm["u"] = dense_init(generator, (D,), **kw)  # per-channel bonus
    for nm in ["wr", "wk", "wv", "wg", "wo"]:
        tm[nm] = dense_init(generator, (D, D), in_axis=0, **kw)
    tm["ln_x"] = full(0.0, (D,))
    cm = {"mu_k": full(0.0, (D,)), "mu_r": full(0.0, (D,)),
          "wk": dense_init(generator, (D, cfg.d_ff), in_axis=0, **kw),
          "wv": dense_init(generator, (cfg.d_ff, D), in_axis=0, **kw),
          "wr": dense_init(generator, (D, D), in_axis=0, **kw)}
    return {"tm": tm, "cm": cm}


def init_rwkv_cache(cfg: ModelConfig, batch, dtype, device=None, lead=()):
    D = cfg.d_model
    hd = cfg.ssm.rwkv_head_dim
    H = D // hd
    lead = tuple(lead)
    return {
        "state": torch.zeros(lead + (batch, H, hd, hd), dtype=torch.float32,
                             device=device),
        "tm_shift": torch.zeros(lead + (batch, D), dtype=dtype,
                                device=device),
        "cm_shift": torch.zeros(lead + (batch, D), dtype=dtype,
                                device=device),
    }


def _token_shift(x, shift):
    """x_prev: the cache's last token ``shift`` [B, D] in decode; in prefill
    (``shift`` None) x shifted right by one step with zeros first."""
    if shift is not None:
        return shift[:, None, :]
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _rwkv_mix(tm, x, x_prev):
    """ddlerp token mixing. x, x_prev: [B, S, D] (x_prev = token-shifted x)."""
    dx = x_prev - x
    xx = x + dx * tm["mu_x"]
    outs = {}
    for nm in ["r", "k", "v", "w", "g"]:
        lo = torch.tanh(xx @ tm[f"lora_{nm}_a"]) @ tm[f"lora_{nm}_b"]
        outs[nm] = x + dx * (tm[f"mu_{nm}"] + lo)
    return outs


def rwkv_time_mix(p, cfg: ModelConfig, x, *, mode, cache):
    """RWKV6 WKV time-mix.  The recurrence runs on the ``rwkv_scan`` kernel,
    from zeros in prefill and training and from the cache's state in
    decode, where the kernel writes the end state back into the cache (and
    this function the token shift).  Training returns no cache (None), as
    the JAX layer does; its gradient goes through ``RwkvScanFn``."""
    tm = p["tm"]
    B, S, D = x.shape
    hd = cfg.ssm.rwkv_head_dim
    H = D // hd

    decode = mode == "decode"
    m = _rwkv_mix(tm, x, _token_shift(x, cache["tm_shift"] if decode
                                      else None))
    r = (m["r"] @ tm["wr"]).view(B, S, H, hd)
    k = (m["k"] @ tm["wk"]).view(B, S, H, hd)
    v = (m["v"] @ tm["wv"]).view(B, S, H, hd)
    g = F.silu(m["g"] @ tm["wg"])
    # data-dependent decay w_t in (0, 1): the add in the params' dtype, then
    # f32 for stability
    w = torch.exp(-torch.exp((tm["w0"] + m["w"]).float())).view(B, S, H, hd)
    u = tm["u"].view(H, hd).float()

    state = cache["state"] if decode else None    # None: zeros
    out, state_end = rwkv_scan(r.float(), k.float(), v.float(), w, u, state,
                               state_out=state)

    # per-head group norm (population variance), then gate and project
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mu) * torch.rsqrt(var + 64e-5)
    out = out.reshape(B, S, D) * (1.0 + tm["ln_x"].float())
    out = out.to(x.dtype) * g.to(x.dtype)
    y = out @ tm["wo"]

    if mode == "train":
        return y, None
    shift = cache["tm_shift"].copy_(x[:, -1, :]) if decode else x[:, -1, :]
    return y, {"state": state_end, "tm_shift": shift}


def rwkv_channel_mix(p, cfg: ModelConfig, x, *, mode, cache):
    """RWKV6 channel-mix.  ``cache``: the [B, D] token shift (decode), which
    is written in place; returns (y, the new shift; None in training)."""
    cm = p["cm"]
    dx = _token_shift(x, cache) - x
    xk = x + dx * cm["mu_k"]
    xr = x + dx * cm["mu_r"]
    k = torch.relu(xk @ cm["wk"]).square()
    v = k @ cm["wv"]
    r = torch.sigmoid(xr @ cm["wr"])
    if mode == "train":
        return r * v, None
    return r * v, (cache.copy_(x[:, -1, :]) if mode == "decode"
                   else x[:, -1, :])


# =============================================================================
# Mamba selective-SSM branch (hymba hybrid heads)
# =============================================================================


def init_mamba(generator, cfg: ModelConfig, dtype, device=None, lead=()):
    s = cfg.ssm
    D = cfg.d_model
    di = s.d_inner_mult * D
    dt_rank = s.dt_rank or max(1, -(-D // 16))
    lead = tuple(lead)
    kw = dict(dtype=dtype, device=device, lead=lead)
    A_log = torch.log(torch.arange(1, s.state_dim + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": dense_init(generator, (D, 2 * di), in_axis=0, **kw),
        "conv_w": dense_init(generator, (s.d_conv, di), in_axis=0, **kw),
        "x_proj": dense_init(generator, (di, dt_rank + 2 * s.state_dim),
                             in_axis=0, **kw),
        "dt_proj": dense_init(generator, (dt_rank, di), in_axis=0, **kw),
        "dt_bias": torch.full(lead + (di,), -4.0, dtype=dtype, device=device),
        # f32 whatever the model's dtype, as in the JAX init
        "A_log": A_log.expand(lead + (di, s.state_dim)).contiguous(),
        "Dskip": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": dense_init(generator, (di, D), in_axis=0, **kw),
    }


def init_mamba_cache(cfg: ModelConfig, batch, dtype, device=None, lead=()):
    s = cfg.ssm
    di = s.d_inner_mult * cfg.d_model
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, di, s.state_dim),
                           dtype=torch.float32, device=device),
    }


def _recur_(dA, hs, h):
    """h_t += dA_t h_{t-1} in place over the paired steps of ``dA`` and
    ``hs`` (sequences of views, each h_t holding its step's dt B x on
    entry), from ``h`` (None: zeros): one ``addcmul_`` a step."""
    for dA_t, h_t in zip(dA, hs):
        if h is not None:
            h_t.addcmul_(dA_t, h)
        h = h_t


def selective_scan(dt, Bt, Ct, x, A, h0):
    """The Mamba recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t =
    h_t C_t, in f32.  dt, x: [B, S, di]; Bt, Ct: [B, S, N]; A: [di, N]; h0:
    [B, di, N] or None (zeros).  Returns (y [B, S, di], h_S).

    exp(dt A) and dt B x are elementwise, so they are formed for every t at
    once (the same f32 values as the JAX step's); only the recurrence loops
    over t, each step one in-place ``addcmul_`` that turns the step's dt B x
    into its state.  Two [B, S, di, N] tensors are alive at a time.  It
    writes its states in place, which autograd cannot differentiate: the
    training path is ``mamba_step``."""
    dA = (dt[..., None] * A).exp_()                    # [B, S, di, N]
    hs = dt[..., None] * Bt[:, :, None, :]
    hs.mul_(x[..., None])                              # dt B x, then h
    _recur_(dA.unbind(1), hs.unbind(1), h0)
    del dA
    y = torch.einsum("bscn,bsn->bsc", hs, Ct)
    return y, hs[:, -1].clone()


class MambaRecurrence(torch.autograd.Function):
    """Every state of h_t = dA_t h_{t-1} + dBx_t over the leading (time)
    axis: dA, dBx [T, B, di, N], h0 [B, di, N] -> hs [T, B, di, N].

    The forward is ``selective_scan``'s loop, one in-place ``addcmul_`` a
    step.  The backward runs the cotangent's recurrence in reverse time,
    g_t = dhs_t + dA_{t+1} g_{t+1}, one ``addcmul_`` a step, then forms
    d dA_t = g_t h_{t-1}, d dBx_t = g_t and d h0 = dA_0 g_0 once for all
    t: what autograd of the JAX step gives, without a graph node a step."""

    @staticmethod
    def forward(ctx, dA, dBx, h0):
        hs = dBx.clone(memory_format=torch.contiguous_format)
        _recur_(dA.unbind(0), hs.unbind(0), h0)
        ctx.save_for_backward(dA, hs, h0)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        dA, hs, h0 = ctx.saved_tensors
        g = dhs.clone(memory_format=torch.contiguous_format)
        gs = g.unbind(0)        # g_t += dA_{t+1} g_{t+1}, t = T-2, ..., 0
        _recur_(dA.unbind(0)[:0:-1], gs[-2::-1], gs[-1])
        d_dA = torch.empty_like(g)
        torch.mul(g[0], h0, out=d_dA[0])
        torch.mul(g[1:], hs[:-1], out=d_dA[1:])
        d_h0 = dA[0] * g[0] if ctx.needs_input_grad[2] else None
        return d_dA, g, d_h0


def mamba_step(A):
    """The JAX branch's scan step for the state matrix ``A`` [di, N]:
    ``step(h, (dt_t, B_t, C_t, x_t)) -> (h, y_t)``, all f32 ([B, di] and
    [B, N] inputs, h [B, di, N]).  Its ``block`` runs the same recurrence
    over [T, ...] inputs at once (``common.time_scan`` takes it): exp(dt A)
    and dt B x formed for every t (the step's f32 values), the states by
    ``MambaRecurrence``, y by one einsum."""
    def step(h, inp):
        dt_t, B_t, C_t, x_t = inp
        dA = torch.exp(dt_t[..., None] * A)
        dBx = dt_t[..., None] * B_t[:, None, :] * x_t[..., None]
        h = dA * h + dBx
        return h, torch.einsum("bcn,bn->bc", h, C_t)

    def block(h, xs):
        dt, Bt, Ct, x = xs
        dA = torch.exp(dt[..., None] * A)
        dBx = dt[..., None] * Bt[:, :, None, :] * x[..., None]
        hs = MambaRecurrence.apply(dA, dBx, h)
        # the carry is a copy: a view would keep every state of the block
        # alive as long as the next chunk keeps its input carry
        return hs[-1].clone(), torch.einsum("tbcn,tbn->tbc", hs, Ct)

    step.block = block
    return step


def mamba_branch(p, cfg: ModelConfig, x, *, mode, cache):
    """Selective scan.  x: [B, S, D] -> ([B, S, D], {"conv", "ssm"}).

    The casts follow the JAX branch step by step: the convolution, dt's
    softplus and the projections run in the model's dtype; dt, B, C and the
    convolved x become f32 for the scan and the skip term; y returns to the
    model's dtype before the gate.  Decode writes the conv history and the
    state into ``cache`` in place.  Train takes the prefill's convolution
    and runs the recurrence from zeros as ``common.chunked_time_scan`` of
    ``mamba_step`` over time-major inputs (the JAX branch's scan), and
    returns None for the cache."""
    s = cfg.ssm
    B, S, D = x.shape
    di = s.d_inner_mult * D
    N = s.state_dim

    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv, width d_conv: in decode an einsum over the
    # history, in prefill a sum of shifted products, as JAX sums them
    if mode == "decode":
        hist = torch.cat([cache["conv"], xi], dim=1)   # [B, d_conv, di]
        conv_out = torch.einsum("bkc,kc->bc", hist, p["conv_w"])[:, None, :]
    elif mode in ("prefill", "train"):
        hist = torch.cat([xi.new_zeros((B, s.d_conv - 1, di)), xi], dim=1)
        conv_out = hist[:, 0:S] * p["conv_w"][0]
        for i in range(1, s.d_conv):
            conv_out = conv_out + hist[:, i:i + S] * p["conv_w"][i]
    else:
        raise ValueError(f"mode {mode!r}")
    xc = F.silu(conv_out)

    proj = xc @ p["x_proj"]
    dt_rank = p["dt_proj"].shape[0]
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"]
                    + p["dt_bias"]).float()            # [B, S, di]
    Bt = proj[..., dt_rank:dt_rank + N].float()        # [B, S, N]
    Ct = proj[..., dt_rank + N:].float()               # [B, S, N]
    A = -torch.exp(p["A_log"])                         # [di, N]
    xcf = xc.float()

    if mode == "train":
        _, ys = common.chunked_time_scan(
            mamba_step(A), xcf.new_zeros((B, di, N)),
            tuple(t.transpose(0, 1).contiguous() for t in (dt, Bt, Ct, xcf)),
            S)
        y = ys.transpose(0, 1)                         # [B, S, di]
    else:
        y, h_end = selective_scan(dt, Bt, Ct, xcf, A,
                                  cache["ssm"] if mode == "decode" else None)
    y = y + xcf * p["Dskip"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ p["out_proj"]

    if mode == "train":
        return out, None
    if mode == "decode":
        new_cache = {"conv": cache["conv"].copy_(hist[:, 1:]),
                     "ssm": cache["ssm"].copy_(h_end)}
    else:
        new_cache = {"conv": hist[:, S:].clone(), "ssm": h_end}
    return out, new_cache
