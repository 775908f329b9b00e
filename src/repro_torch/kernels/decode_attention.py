"""Decode attention on hand-written CUDA kernels: one query token per head
against the KV cache.

The counterpart of ``repro/kernels/decode_attention.py``: for each (batch,
kv head) the G query heads score every cache position, positions at or past
``k_valid`` are masked with -1e30, and the softmax-weighted values are summed
in f32.

``decode_attention`` takes its plain PyTorch version
(``decode_attention_plain``) for tensors on the CPU and launches
``csrc/decode_attention.cu`` (a split-K pass and a combine pass, one launch
count) for tensors on the card; there is no other path.
``decode_attention.launches`` counts launches.  Unlike the Pallas wrapper it
takes any cache length, not only multiples of a block.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, NEG_INF,
                                                 check_attention_inputs)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_F, _P]


def decode_attention_plain(q, k, v, k_valid):
    """The plain PyTorch version of ``decode_attention`` (one softmax over
    the whole buffer; the same f32 math)."""
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    qf = q[:, 0].reshape(B, K, H // K, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float()) * (1.0 / math.sqrt(hd))
    masked = torch.arange(S, device=q.device) >= k_valid
    p = torch.softmax(s.masked_fill(masked, NEG_INF), dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q, k, v, k_valid):
    """q: [B, 1, H, hd]; k, v: [B, S, K, hd] with H % K == 0, float32 or
    bfloat16, contiguous, on one device; ``k_valid``: the number of valid
    cache positions (an int; a tensor is read back to the host).  Returns
    [B, 1, H, hd] in q's dtype."""
    B, Sq, H, hd, S, K = check_attention_inputs("decode_attention", q, k, v)
    if Sq != 1:
        raise ValueError(f"decode_attention: {Sq} query tokens, expected 1")
    k_valid = int(k_valid)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_valid)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kv_end = min(k_valid, S) if k_valid >= 1 else S
    chunk = 64 if hd <= 128 else 32    # cache positions per split (smem)
    n_split = -(-kv_end // chunk)
    rows = n_split * B * H      # one partial (m, l, acc) per split and head
    scratch = torch.empty(rows * (hd + 2), dtype=torch.float32,
                          device=q.device)
    pm, pl, pacc = scratch[:rows], scratch[rows:2 * rows], scratch[2 * rows:]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("decode_attention", "synergai_decode_attention",
                      _ARGTYPES, "synergai_decode_error_string",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), pm.data_ptr(), pl.data_ptr(),
                      pacc.data_ptr(), DTYPES[q.dtype], B, S, H, K, hd,
                      k_valid, kv_end, chunk, 1.0 / math.sqrt(hd), stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
