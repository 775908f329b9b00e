"""Prefill (flash) attention on hand-written CUDA kernels, with its gradient.

The counterpart of ``repro/kernels/flash_attention.py``: blockwise
online-softmax attention with GQA (head h uses kv head h // G), causal and
sliding-window masks (-1e30), f32 accumulation and the input dtype out.

``flash_attention`` takes its plain PyTorch version (``flash_attention_plain``)
for tensors on the CPU and launches ``csrc/flash_attention.cu`` for tensors on
the card; there is no other path.  Unlike the Pallas wrapper it takes any Sq
and Sk, not only multiples of a block.

Its gradient is ``FlashAttentionFn``, a ``torch.autograd.Function``, taken
whenever grad mode is on and an input requires grad: its forward keeps the
log-sum-exp of each row (the kernel's ``lse`` output), and its backward is a
second kernel, ``csrc/flash_attention_bwd.cu`` (``flash_attention_bwd``),
which the JAX package does not have (its training differentiates the XLA-path
attention with ``jax.grad``).  On CPU tensors the same Function runs
``flash_attention_plain`` and ``flash_attention_bwd_plain``, the explicit
formula dS = P (dP - D), so the CPU tests run the card's wiring.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch import _meta
from repro_torch.kernels import _build, _local

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 10 + [_F, _P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 10 + [_F, _P]


def check_attention_inputs(what, q, k, v):
    """Validate q [B, Sq, H, hd], k and v [B, Sk, K, hd] for the kernels;
    returns (B, Sq, H, hd, Sk, K)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"{what}: {name} must be a 4-D tensor")
        if x.dtype not in DTYPES:
            raise TypeError(f"{what}: {name} has dtype {x.dtype}; the "
                            "kernels take float32 or bfloat16")
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{what}: q, k, v must share dtype and device")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    Sk, K = k.shape[1], k.shape[2]
    if K == 0 or H % K != 0:
        raise ValueError(f"{what}: {H} query heads over {K} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} is not one of {HEAD_DIMS}")
    if Sk == 0:
        raise ValueError(f"{what}: no keys")
    dev = q.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what} runs on cpu, cuda or meta (shapes only), "
                         f"not {dev}")
    if dev.type == "cuda" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{what}: the kernels need 16-byte aligned tensors")
    return B, Sq, H, hd, Sk, K


def fits_kernels(q, k, v) -> bool:
    """Whether the attention kernels take these shapes: q [B, Sq, H, hd], k
    and v [B, Sk, K, hd] of one shape, H % K == 0, hd in ``HEAD_DIMS`` and at
    least one key.  A plain predicate on shapes that raises nothing; the
    model routes by it, and ``check_attention_inputs`` still raises when a
    wrapper is called with shapes it refuses.  On DTensors it reads the
    global shapes: the local shards that the wrappers compute on
    (``local_placements``: batch and heads divided alike, the rest whole)
    have each property it tests exactly where the global shapes do."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return False
    B, _, H, hd = q.shape
    Kb, Sk, K, khd = k.shape
    return (Kb == B and khd == hd and hd in HEAD_DIMS and Sk > 0 and K > 0
            and H % K == 0)


def _visible(Sq, Sk, causal, window, device):
    """[Sq, Sk] bool: the (query, key) pairs the masks leave visible."""
    q_pos = torch.arange(Sq, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= q_pos - k_pos < window
    return ok


def _scores(q, k, causal, window):
    """The scaled, masked f32 scores [B, K, G, Sq, Sk] and q as
    [B, Sq, K, G, hd] f32."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qf = q.reshape(B, Sq, K, H // K, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * (1.0 / math.sqrt(hd))
    return s.masked_fill(~_visible(Sq, Sk, causal, window, q.device),
                         NEG_INF), qf


def flash_attention_plain(q, k, v, *, causal=True, window=None,
                          return_lse=False):
    """The plain PyTorch version of ``flash_attention`` (one softmax over
    all keys instead of the online one; the same f32 math).  With
    ``return_lse`` also each row's log-sum-exp of the scaled, masked
    scores, [B, H, Sq] f32 (natural log), as the kernel writes it."""
    B, Sq, H, hd = q.shape
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    out = out.reshape(B, Sq, H, hd).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out


def _launch_forward(q, k, v, causal, window, with_lse):
    """The forward kernel on card tensors: out, and the log-sum-exp
    [B, H, Sq] f32 when ``with_lse`` (else None, a null pointer)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if q.device.type == "meta":
        _meta.kernel_flops("flash_attention", 4 * hd * B * H * visible_pairs(
            Sq, Sk, causal, window))
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("flash_attention", "synergai_flash_attention",
                      _ARGTYPES, "synergai_flash_error_string",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(),
                      lse.data_ptr() if lse is not None else None,
                      DTYPES[q.dtype], B, Sq, Sk, H, K, hd,
                      int(bool(causal)), int(window is not None), window or 0,
                      1.0 / math.sqrt(hd), stream)
    flash_attention.launches += 1
    return out, lse


def _check_sees_a_key(what, Sq, Sk, window):
    """Every query row must see a key: under a window, Sq - Sk < window
    (a row that sees none has no gradient the forward defines)."""
    if window is not None and Sq - Sk >= window:
        raise ValueError(f"{what}: with Sq {Sq}, Sk {Sk} and window {window} "
                         "some query rows see no key")


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with its gradient.  Forward: the kernel with its
    log-sum-exp (the plain version on CPU tensors); it saves q, k, v, out
    and lse.  Backward: ``flash_attention_bwd`` (which runs
    ``flash_attention_bwd_plain`` on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal=causal,
                                             window=window, return_lse=True)
        else:
            out, lse = _launch_forward(q, k, v, causal, window, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def local_placements(q, k):
    """The layout of an attention call on DTensors: q's batch (dim 0) and
    head (dim 2) shards kept where they divide and k's kv heads split alike
    (so each rank's query heads use its own kv heads), the sequence and
    head_dim whole; the same for k, v and the output."""
    return _local.kept(q, {0: q.shape[0], 2: k.shape[2]})


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] with H % K == 0, float32 or
    bfloat16, contiguous, on one device.  ``window``: keys with
    q_pos - k_pos >= window are masked (None: no window).  Returns
    [B, Sq, H, hd] in q's dtype, through ``FlashAttentionFn`` when grad mode
    is on and an input requires grad.  On DTensors the same call runs on the
    local shards of ``local_placements``."""
    if isinstance(q, DTensor):
        pl = local_placements(q, k)
        return _local.call(
            lambda q, k, v: _flash_attention(q, k, v, causal, window),
            (q, k, v), (pl, pl, pl), pl)
    return _flash_attention(q, k, v, causal, window)


def _flash_attention(q, k, v, causal, window):
    B, Sq, H, hd, Sk, K = check_attention_inputs("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if _wants_grad(q, k, v):
        _check_sees_a_key("flash_attention", Sq, Sk, window)
        return FlashAttentionFn.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    return _launch_forward(q, k, v, causal, window, False)[0]


def visible_pairs(Sq, Sk, causal, window):
    """The (query, key) pairs of one head that the masks leave visible:
    query i sees the keys j < Sk with j <= i (causal) and i - j < window."""
    i = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(i, max=Sk - 1) if causal else torch.full_like(i, Sk - 1)
    lo = (torch.clamp(i - window + 1, min=0) if window is not None
          else torch.zeros_like(i))
    return int(torch.clamp(hi - lo + 1, min=0).sum())


flash_attention.launches = 0


# ----------------------------------------------------------------------------
# the backward


def _check_bwd_inputs(what, q, k, v, out, lse, dout, window):
    B, Sq, H, hd, Sk, K = check_attention_inputs(what, q, k, v)
    for name, x in (("out", out), ("dout", dout)):
        if (not isinstance(x, torch.Tensor) or x.shape != q.shape
                or x.dtype != q.dtype or x.device != q.device):
            raise ValueError(f"{what}: {name} must be a tensor of q's shape, "
                             "dtype and device")
    if (not isinstance(lse, torch.Tensor) or lse.shape != (B, H, Sq)
            or lse.dtype != torch.float32 or lse.device != q.device):
        raise ValueError(f"{what}: lse must be a float32 [{B}, {H}, {Sq}] "
                         "tensor on q's device")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} must be >= 1")
    _check_sees_a_key(what, Sq, Sk, window)
    if q.device.type == "cuda":
        if not all(x.is_contiguous() for x in (out, dout, lse)):
            raise ValueError(f"{what}: out, dout and lse must be contiguous")
        if any(x.data_ptr() % 16 for x in (out, dout, lse)):
            raise ValueError(f"{what}: the kernels need 16-byte aligned "
                             "tensors")
    return B, Sq, H, hd, Sk, K


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal=True,
                              window=None):
    """The plain PyTorch version of ``flash_attention_bwd``: the explicit
    formula, in f32, summed over the G query heads of each kv head.
        P = exp(s - lse), D = rowsum(dout o out), dP = dout V^T,
        dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q, dV = P^T dout
    Returns (dq, dk, dv) in the inputs' dtype."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    s, qf = _scores(q, k, causal, window)
    p = torch.exp(s - lse.reshape(B, K, G, Sq)[..., None])
    del s
    of = dout.reshape(B, Sq, K, G, hd).float()
    dp = torch.einsum("bqkgh,bskh->bkgqs", of, v.float())
    d = (dout.float() * out.float()).sum(-1)              # [B, Sq, H]
    ds = p * (dp - d.transpose(1, 2).reshape(B, K, G, Sq)[..., None])
    del dp
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, of)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True,
                        window=None):
    """The gradient of ``flash_attention`` with respect to q, k and v, given
    its output ``out``, its log-sum-exp ``lse`` [B, H, Sq] f32 (the
    forward's, natural log) and the output's gradient ``dout``: (dq, dk, dv)
    in the inputs' dtype, f32 inside.  The masks are the forward's; every
    query row must see a key.  Launches ``csrc/flash_attention_bwd.cu`` (its
    three kernels) on card tensors, runs ``flash_attention_bwd_plain`` on
    CPU tensors."""
    B, Sq, H, hd, Sk, K = _check_bwd_inputs("flash_attention_bwd", q, k, v,
                                            out, lse, dout, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal, window=window)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    if q.device.type == "meta":
        # s and dP recomputed, then dV, dS's products dQ and dK: 10 hd a
        # visible pair
        _meta.kernel_flops("flash_attention_bwd", 10 * hd * B * H *
                           visible_pairs(Sq, Sk, causal, window))
        return dq, dk, dv
    dsum = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("flash_attention_bwd", "synergai_flash_attention_bwd",
                      _BWD_ARGTYPES, "synergai_flash_bwd_error_string",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                      dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), DTYPES[q.dtype], B, Sq, Sk, H, K, hd,
                      int(bool(causal)), int(window is not None), window or 0,
                      1.0 / math.sqrt(hd), stream)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
