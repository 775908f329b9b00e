"""Prefill (flash) attention on a hand-written CUDA kernel.

The counterpart of ``repro/kernels/flash_attention.py``: blockwise
online-softmax attention with GQA (head h uses kv head h // G), causal and
sliding-window masks (-1e30), f32 accumulation and the input dtype out.

``flash_attention`` takes its plain PyTorch version (``flash_attention_plain``)
for tensors on the CPU and launches ``csrc/flash_attention.cu`` for tensors on
the card; there is no other path.  ``flash_attention.launches`` counts kernel
launches.  Unlike the Pallas wrapper it takes any Sq and Sk, not only
multiples of a block.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 10 + [_F, _P]


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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {dev}")
    if dev.type == "cuda" and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{what}: the kernels need 16-byte aligned tensors")
    return B, Sq, H, hd, Sk, K


def fits_kernels(q, k, v) -> bool:
    """Whether the attention kernels take these shapes: q [B, Sq, H, hd], k
    and v [B, Sk, K, hd] of one shape, H % K == 0, hd in ``HEAD_DIMS`` and at
    least one key.  A plain predicate on shapes that raises nothing; the
    model routes by it, and ``check_attention_inputs`` still raises when a
    wrapper is called with shapes it refuses."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        return False
    B, _, H, hd = q.shape
    Kb, Sk, K, khd = k.shape
    return (Kb == B and khd == hd and hd in HEAD_DIMS and Sk > 0 and K > 0
            and H % K == 0)


def flash_attention_plain(q, k, v, *, causal=True, window=None):
    """The plain PyTorch version of ``flash_attention`` (one softmax over
    all keys instead of the online one; the same f32 math)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, Sq, K, G, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * (1.0 / math.sqrt(hd))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= q_pos - k_pos < window
    p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] with H % K == 0, float32 or
    bfloat16, contiguous, on one device.  ``window``: keys with
    q_pos - k_pos >= window are masked (None: no window).  Returns
    [B, Sq, H, hd] in q's dtype."""
    B, Sq, H, hd, Sk, K = check_attention_inputs("flash_attention", q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("flash_attention", "synergai_flash_attention",
                      _ARGTYPES, "synergai_flash_error_string",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), DTYPES[q.dtype], B, Sq, Sk, H, K, hd,
                      int(bool(causal)), int(window is not None), window or 0,
                      1.0 / math.sqrt(hd), stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
