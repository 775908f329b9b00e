# Port of repro/models/common.py: the same primitives on torch; attention's two self-attention shapes go to the CUDA kernels.
"""Shared model primitives: initializers, norms, RoPE, attention, MLPs,
embedding and head.

``naive_attention`` and ``chunked_flash_attention`` are the JAX package's
XLA paths, written in PyTorch.  ``attention`` keeps the JAX signature and
sends the two self-attention shapes of ``layers.attn_sublayer`` to the kernel
wrappers (``kernels.flash_attention`` for prefill, ``kernels.decode_attention``
for one decode token), which compute the same function: this is the swap the
JAX package's note describes ("swapped in on real hardware").  It routes by
shape (``fits_kernels``): shapes the kernels do not take, such as a v head
dim that differs from q's, take the XLA paths.  On CPU tensors the wrappers
run their plain versions; on the card they launch the kernels for every
length.

Where torch and JAX differ the port follows JAX: ``gelu`` is the tanh
approximation, norms run in f32 and cast back, RoPE promotes to f32 and casts
back.  ``chunked_time_scan`` is the JAX package's two-level time scan for
training a recurrence (the Mamba branch's in ``mode="train"``): a loop of
steps in place of ``lax.scan``, each chunk of 64 steps under
``torch.utils.checkpoint`` in place of ``jax.checkpoint``.  Serving does not
use it: the RWKV layers call the ``rwkv_scan`` kernel, the Mamba branch's
prefill and decode ``layers.selective_scan``.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import _meta
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention, fits_kernels

# ----------------------------------------------------------------------------
# initializers (the JAX distributions; a torch.Generator in place of a key)


def _normal(generator, shape, device):
    if torch.device(device if device is not None else "cpu").type == "meta":
        return torch.empty(shape, device="meta")   # shapes only: no draw
    x = torch.randn(shape, generator=generator, device=generator.device)
    return x.to(device)


def dense_init(generator, shape, in_axis=-2, dtype=torch.float32,
               device=None, lead=()):
    """Normal with std 1/sqrt(fan_in), fan-in on ``in_axis`` of ``shape``;
    ``lead`` prepends stacking dimensions (one draw per layer).  The result
    is allocated in ``dtype`` and filled one leading index at a time (drawn
    in f32, scaled in place, cast into its slot), so the f32 temporary is
    one layer's tensor, not the whole stack's."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype,
                      device=device if device is not None
                      else generator.device)
    if out.device.type == "meta":
        return out
    for idx in itertools.product(*(range(n) for n in lead)):
        x = _normal(generator, tuple(shape), out.device)
        out[idx] = x.div_(math.sqrt(fan_in))
    return out


def embed_init(generator, shape, dtype=torch.float32, device=None):
    return (_normal(generator, tuple(shape), device) * 0.02).to(dtype)


# ----------------------------------------------------------------------------
# norms


def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def head_rms_norm(x, scale, eps=1e-6):
    """qk-norm: RMSNorm over the head_dim of [B, S, H, hd]."""
    return rms_norm(x, scale, eps)


# ----------------------------------------------------------------------------
# RoPE


def rope_freqs(head_dim: int, theta: float, positions):
    """positions: [...]; returns cos/sin of shape [..., head_dim/2]."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    inv = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: [B, S, H, hd]; cos/sin: [B?, S, hd/2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:    # [S, hd/2] -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == 3:  # [B, S, hd/2]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ----------------------------------------------------------------------------
# attention


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """Additive mask bias [Sq, Sk] from query/key absolute positions."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(ok, 0.0, -1e30).float()


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=0,
                    k_valid=None):
    """Reference attention.  q: [B,Sq,H,hd], k/v: [B,Sk,K,hd] (GQA K|H).

    ``q_offset``: absolute position of q[0] (decode).  ``k_valid``: number of
    valid kv entries (decode with a partially filled cache).
    """
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    hd_v = v.shape[-1]
    G = H // K
    qr = splittable(q, 2, K).reshape(B, Sq, K, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qr.float(),
                          k.float()) / math.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    bias = _mask_bias(q_pos, k_pos, causal, window)
    if k_valid is not None:
        bias = bias + torch.where(k_pos[None, :] < k_valid, 0.0, -1e30)
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return splittable_grad(out.reshape(B, Sq, H, hd_v), 2, K).to(q.dtype)


def chunked_flash_attention(q, k, v, *, causal=True, window=None,
                            chunk=1024, q_offset=0, k_valid=None):
    """Online-softmax attention over KV chunks: the JAX package's XLA
    'flash' path (a Python loop in place of ``lax.scan``; on meta tensors
    one chunk, counted for every chunk: ``_meta.trips``)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    if Sk % chunk != 0:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, k_valid=k_valid)
    G = H // K
    qf = q.float()
    scale = 1.0 / math.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), -math.inf, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, hd_v), device=q.device)
    for idx in _meta.trips(Sk // chunk, q):
        kc = k[:, idx * chunk:(idx + 1) * chunk]
        vc = v[:, idx * chunk:(idx + 1) * chunk]
        if G > 1:  # expand grouped kv heads to the full query-head axis
            kc = kc.repeat_interleave(G, dim=2)
            vc = vc.repeat_interleave(G, dim=2)
        k_pos = idx * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bqhd,bshd->bhqs", qf, kc.float()) * scale
        ok = torch.ones((Sq, chunk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            ok &= q_pos[:, None] - k_pos[None, :] < window
        if k_valid is not None:
            ok &= (k_pos < k_valid)[None, :]
        s = s + torch.where(ok, 0.0, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqs,bshd->bhqd", p,
                                                   vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(cfg: ModelConfig, q, k, v, *, causal=True, window=None,
              q_offset=0, k_valid=None):
    """Dispatch by shape.  The two self-attention shapes of
    ``attn_sublayer`` run on the kernel wrappers, which compute the same
    function as the XLA paths below (the JAX package's Pallas kernels,
    "swapped in on real hardware"): prefill (Sq == Sk from position 0, no
    ``k_valid``) on ``flash_attention``, one decode token against a cache
    with ``k_valid`` on ``decode_attention`` -- each only where
    ``fits_kernels`` says the kernels take q, k and v as they are.  Every
    other call, a v head dim other than q's and k's (MLA) among them, takes
    the JAX package's rule: chunked flash for long key sequences, naive for
    short ones.  This is routing, not a fallback: there is no ``try``, a
    shape the kernels take never leaves them, and the wrappers still raise
    on shapes they refuse when they are called directly."""
    Sq, Sk = q.shape[1], k.shape[1]
    if q_offset == 0 and fits_kernels(q, k, v):
        if Sq == Sk and k_valid is None:
            return flash_attention(q, k, v, causal=causal, window=window)
        if Sq == 1 and k_valid is not None and not causal and window is None:
            return decode_attention(q, k, v, k_valid)
    if Sk >= cfg.flash_threshold:
        return chunked_flash_attention(q, k, v, causal=causal, window=window,
                                       chunk=cfg.attn_chunk, q_offset=q_offset,
                                       k_valid=k_valid)
    return naive_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, k_valid=k_valid)


# ----------------------------------------------------------------------------
# gated MLPs


def init_mlp(generator, d_model, d_ff, dtype, device=None, lead=()):
    return {
        "wi": dense_init(generator, (d_model, d_ff), dtype=dtype,
                         device=device, lead=lead),
        "wg": dense_init(generator, (d_model, d_ff), dtype=dtype,
                         device=device, lead=lead),
        "wo": dense_init(generator, (d_ff, d_model), dtype=dtype,
                         device=device, lead=lead),
    }


def mlp(params, x, act: str):
    a = x @ params["wi"]
    g = x @ params["wg"]
    gate = F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)
    return (a * gate) @ params["wo"]


# ----------------------------------------------------------------------------
# embedding / head


def whole(t, dims=None):
    """``t`` with ``dims`` (all when None) whole on every rank, and its
    pending sums reduced, where it is a DTensor, else ``t`` itself: for what
    DTensor's rules cannot take sharded.  Its embedding and gather rules
    leave a vocab-sharded result that its own redistribution then cannot
    reduce (so the lookups read a whole vocabulary), and a view cannot fold
    dims of which a second one is sharded (so a product's folded dims are
    whole past the first)."""
    if not isinstance(t, DTensor):
        return t
    dims = None if dims is None else [d % t.dim() for d in dims]
    pl = [Replicate() if p.is_partial() or isinstance(p, Shard)
          and (dims is None or p.dim in dims) else p for p in t.placements]
    return t.redistribute(t.device_mesh, pl)


def splittable(t, dim, lead):
    """``t``, made whole along ``dim`` where it is a DTensor that shards
    that dim over more ranks than ``lead`` divides by: a view that
    unflattens ``dim`` into (``lead``, rest) needs every shard to hold whole
    rows of ``lead`` (DTensor refuses "to unflatten an unevenly sharded
    tensor": 8 kv heads or 25 heads over a 16-way axis).  Else ``t``."""
    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    n = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                  if isinstance(p, Shard) and p.dim == dim)
    return whole(t, [dim]) if lead % n else t


class _SplittableGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient ``splittable``."""

    @staticmethod
    def forward(ctx, t, dim, lead):
        ctx.dim, ctx.lead = dim, lead
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, ctx.dim, ctx.lead), None, None


def splittable_grad(t, dim, lead):
    """``t`` itself, with its gradient made ``splittable(g, dim, lead)`` in
    the backward: for a flattened weight whose gradient the view back to
    its shape unflattens.  On a plain tensor or without grad, ``t``."""
    if not isinstance(t, DTensor) or not t.requires_grad:
        return t
    return _SplittableGrad.apply(t, dim, lead)


def init_embedding(generator, cfg: ModelConfig, dtype, device=None):
    return {
        "tok": embed_init(generator, (cfg.vocab, cfg.d_model), dtype=dtype,
                          device=device),
        "head": dense_init(generator, (cfg.d_model, cfg.vocab), dtype=dtype,
                           device=device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
    }


def embed(params, cfg: ModelConfig, tokens):
    x = F.embedding(tokens, whole(params["tok"]))
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(x.dtype)
    return x


def unembed(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["head"]


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


# ----------------------------------------------------------------------------
# time scans (recurrences in training)


def time_scan(step, carry, xs):
    """``lax.scan(step, carry, xs)``: ``step(carry, x_t) -> (carry, y_t)``
    over the leading axis of ``xs``'s leaves; returns (the final carry, the
    y_t stacked to [T, ...]).  A step that carries a ``block`` attribute
    runs the whole of ``xs`` through ``step.block(carry, xs)`` instead,
    which must return what the loop would (the Mamba step forms its
    elementwise terms for every t at once and loops only the recurrence)."""
    block = getattr(step, "block", None)
    if block is not None:
        return block(carry, xs)
    ys, n = [], tree_leaves(xs)[0].shape[0]
    for t in _meta.trips(n, tree_leaves(xs)[0]):
        carry, y = step(carry, tree_map(lambda a: a[t], xs))
        ys.append(y)
    if len(ys) < n:              # on meta tensors: one trip, n results
        ys = ys * n
    return carry, tree_map(lambda *a: torch.stack(a), *ys)


def chunked_time_scan(step, init, xs, length: int, chunk: int = 64):
    """Two-level time scan for recurrences (RWKV/Mamba training), the JAX
    package's.

    A flat scan over S steps keeps its carry (the recurrent state) at
    every step for the backward pass: O(S * state) memory.  Chunking keeps
    the carry only at chunk boundaries (O(S / chunk * state)): each chunk
    runs under ``checkpoint`` (non-reentrant), which saves the chunk's
    input carry and recomputes the chunk in the backward, so its per-step
    residuals live only during that chunk's backward, as under
    ``jax.checkpoint(inner, policy=nothing_saveable)``.

    ``xs``: pytree of [S, ...] tensors scanned over the leading axis.
    Returns (final_carry, ys stacked to [S, ...]).  Scans flat when
    ``length % chunk != 0 or length <= chunk``.  On meta tensors both loops
    run one trip, counted for every trip (``_meta.trips``)."""
    if length % chunk != 0 or length <= chunk:
        return time_scan(step, init, xs)
    carry, ys, n = init, [], length // chunk
    for i in _meta.trips(n, tree_leaves(xs)[0]):
        xc = tree_map(lambda a: a[i * chunk:(i + 1) * chunk], xs)
        carry, y = _meta.checkpoint(time_scan, step, carry, xc)
        ys.append(y)
    if len(ys) < n:              # on meta tensors: one trip, n results
        ys = ys * n
    return carry, tree_map(lambda *a: torch.cat(a), *ys)
