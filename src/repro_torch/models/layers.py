# Port of repro/models/layers.py: the GQA self-attention sublayer on torch.
"""The GQA self-attention sublayer (dense decoders and, in later slices, the
MoE, VLM and hybrid stacks), with its KV cache.

    init_attention(generator, cfg, dtype) -> params
    attn_sublayer(params, cfg, x, *, mode, cache, pos, window) -> (y, cache)

``mode``: "prefill" | "decode" ("train" waits for the training slice);
``cache``: {"k", "v"} [B, buf, K, hd] (None in prefill); ``pos``: int, the
absolute position of the incoming token (decode).

The cache is written in place (where JAX returns an updated buffer).  The
JAX package's ``ONEHOT_CACHE_UPDATE`` and ``SHARDED_DECODE_ATTN`` switches
are sharding options, off by default, and wait for the sharding slice.
Cross-attention, MLA, MoE, RWKV and Mamba sublayers wait for their slices
(``decoder.py`` raises for them).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
