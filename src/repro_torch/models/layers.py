# Port of repro/models/layers.py: the GQA self-attention and RWKV6 sublayers on torch; the WKV recurrence runs on the CUDA kernel.
"""The GQA self-attention sublayer (dense decoders and, in later slices, the
MoE, VLM and hybrid stacks), with its KV cache, and the RWKV6 (Finch) time-
and channel-mix sublayers, with their recurrent cache.

    init_attention(generator, cfg, dtype) -> params
    attn_sublayer(params, cfg, x, *, mode, cache, pos, window) -> (y, cache)
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
remat device for training), runs on ``kernels.rwkv_scan``.  The JAX
package's ``ONEHOT_CACHE_UPDATE`` and ``SHARDED_DECODE_ATTN`` switches are
sharding options, off by default, and wait for the sharding slice.
Cross-attention, MLA, MoE and Mamba sublayers wait for their slices
(``decoder.py`` raises for them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv_scan import rwkv_scan
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
