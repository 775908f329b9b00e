# Port of repro/models/layers.py: the GQA self-attention, MoE FFN and RWKV6 sublayers on torch; the MoE router and the WKV recurrence run on CUDA kernels.
"""The GQA self-attention sublayer (dense and MoE decoders and, in later
slices, the VLM and hybrid stacks), with its KV cache; the MoE FFN
(GShard-style capacity dispatch); and the RWKV6 (Finch) time- and
channel-mix sublayers, with their recurrent cache.

    init_attention(generator, cfg, dtype) -> params
    attn_sublayer(params, cfg, x, *, mode, cache, pos, window) -> (y, cache)
    init_moe(generator, cfg, dtype) -> {"router" (f32), "wi", "wg", "wo"}
    moe_ffn(params, cfg, x) -> y
    init_rwkv_layer(generator, cfg, dtype) -> {"tm", "cm"}
    rwkv_time_mix(params, cfg, x, *, mode, cache) -> (y, {"state", "tm_shift"})
    rwkv_channel_mix(params, cfg, x, *, mode, cache) -> (y, cm_shift)

``mode``: "prefill" | "decode" ("train" waits for the training slice);
``cache``: {"k", "v"} [B, buf, K, hd] (None in prefill), or the RWKV cache
{"state" [B, H, hd, hd] f32, "tm_shift", "cm_shift" [B, D]}; ``pos``: int,
the absolute position of the incoming token (decode).

Caches are written in place in decode (where JAX returns updated buffers):
the attention cache at the token's slot, the RWKV state by the ``rwkv_scan``
kernel itself (``state_out=state``) and the two token shifts by a copy.  The
WKV recurrence, which the JAX layer runs as ``common.chunked_time_scan`` (a
remat device for training), runs on ``kernels.rwkv_scan``.  The MoE
router (the JAX ``_route``/``_route_grouped``: logits, softmax, top-k mask
and renormalized gates) runs on ``kernels.moe_routing``; the expert products
stay ``torch.einsum``, plain large products that the JAX package leaves to
XLA.  The JAX package's ``ONEHOT_CACHE_UPDATE`` and ``SHARDED_DECODE_ATTN``
switches and the MoE sharding constraints (``constrain_moe_groups``,
``constrain_moe_expert``, the identity off a device mesh) wait for the
sharding slice.  Cross-attention, MLA and Mamba sublayers wait for their
slices (``decoder.py`` raises for them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_routing import moe_routing
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.models import common
from repro_torch.models.common import (apply_rope, attention, dense_init,
                                       head_rms_norm, rope_freqs)


def _cache_write(buf, update, idx):
    """Write ``update`` [B, 1, ...] into ``buf`` [B, S, ...] at ``idx``, in
    place; ``idx`` is clamped into the buffer as ``dynamic_update_slice``
    clamps it."""
    idx = min(max(int(idx), 0), buf.shape[1] - 1)
    buf[:, idx] = update[:, 0]
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

    if mode == "prefill":
        out = attention(cfg, q, k, v, causal=True, window=window)
        if window is not None:
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
        raise NotImplementedError(
            f"mode {mode!r}: training waits for the training slice")
    H, hd = cfg.n_heads, cfg.head_dim
    y = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return y, new_cache


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
    xg = x.reshape(B, G, g, D)
    gates, mask = _route_grouped(p, cfg, xg)
    # position of each token within its expert's capacity buffer (per group)
    pos_in_exp = torch.cumsum(mask, dim=2) - 1.0
    keep = mask * (pos_in_exp < capacity)
    slots = torch.arange(capacity, dtype=torch.int32, device=x.device)
    dispatch = keep[..., None] * (
        pos_in_exp.to(torch.int32)[..., None] == slots)    # [B,G,T,E,C]
    combine = dispatch * gates[..., None]
    dt = x.dtype
    exp_in = torch.einsum("bgtec,bgtd->bgecd", dispatch.to(dt), xg)
    a = torch.einsum("bgecd,edf->bgecf", exp_in, p["wi"])
    h = torch.einsum("bgecd,edf->bgecf", exp_in, p["wg"])
    act = F.gelu(h, approximate="tanh") if cfg.act == "gelu" else F.silu(h)
    exp_out = torch.einsum("bgecf,efd->bgecd", a * act, p["wo"])
    out = torch.einsum("bgtec,bgecd->bgtd", combine.to(dt), exp_out)
    out = out.reshape(B, S, D)
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
    from zeros in prefill and from the cache's state in decode, where the
    kernel writes the end state back into the cache (and this function the
    token shift)."""
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

    shift = cache["tm_shift"].copy_(x[:, -1, :]) if decode else x[:, -1, :]
    return y, {"state": state_end, "tm_shift": shift}


def rwkv_channel_mix(p, cfg: ModelConfig, x, *, mode, cache):
    """RWKV6 channel-mix.  ``cache``: the [B, D] token shift (decode), which
    is written in place; returns (y, the new shift)."""
    cm = p["cm"]
    dx = _token_shift(x, cache) - x
    xk = x + dx * cm["mu_k"]
    xr = x + dx * cm["mu_r"]
    k = torch.relu(xk @ cm["wk"]).square()
    v = k @ cm["wv"]
    r = torch.sigmoid(xr @ cm["wr"])
    return r * v, (cache.copy_(x[:, -1, :]) if mode == "decode"
                   else x[:, -1, :])
