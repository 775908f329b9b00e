"""Decode attention on hand-written CUDA kernels: one query token per head
against the KV cache.

The counterpart of ``repro/kernels/decode_attention.py``: for each (batch,
kv head) the G query heads score every cache position, positions at or past
``k_valid`` are masked with -1e30, and the softmax-weighted values are summed
in f32.

``decode_attention`` takes its plain PyTorch version
(``decode_attention_plain``) for tensors on the CPU and launches
``csrc/decode_attention.cu`` (one kernel: split-K over the cache, the last
CTA of each kv head merging the splits in order) for tensors on the card;
there is no other path.  ``plan_splits`` sizes the split.
``decode_attention.launches`` counts launches.  Unlike the Pallas wrapper it
takes any cache length, not only multiples of a block.  The kernel has no
backward: on the card it refuses to run when grad mode is on and an input
requires grad (``_build.refuse_grad``), rather than return a tensor cut off
from the graph.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, _local
from repro_torch.kernels.flash_attention import (DTYPES, NEG_INF,
                                                 check_attention_inputs,
                                                 local_placements)

TILE = 32            # keys a stage of the kernel's ring holds
TARGET_CTAS = 264    # two CTAs on each of the H100's 132 SMs
MERGE_BYTES = 96 * 1024  # the partials the last CTA stages in shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F, _P]


def rows_per_cta(G):
    """The query rows of one kv head a CTA takes: 4 for G <= 4, else 8."""
    return 4 if G <= 4 else 8


def row_blocks(G):
    """The kernel's blocks of query rows per kv head."""
    return -(-G // rows_per_cta(G))


def plan_splits(B, K, G, kv_end, hd):
    """The number of splits of the ``kv_end`` visible cache positions: as
    many as fill the card with about two CTAs an SM without going over
    (``TARGET_CTAS`` over the grid's B * K * ``row_blocks(G)`` rows; one
    more split would leave some SMs a third CTA, which ran slower on the
    H100), each split at least one whole ``TILE`` of keys, and no more than
    the last CTA can stage: a partial (m, l and hd sums, f32) of each split
    and row in ``MERGE_BYTES``."""
    n_tiles = -(-kv_end // TILE)
    staged = MERGE_BYTES // (4 * rows_per_cta(G) * (hd + 4))
    return max(1, min(n_tiles, staged,
                      TARGET_CTAS // (B * K * row_blocks(G))))


def split_keys(n_split, kv_end):
    """The cache positions [start, end) of each split, as the kernel cuts
    them: split s takes the tiles [s * n // n_split, (s + 1) * n // n_split)
    of the n = ceil(kv_end / TILE)."""
    n = -(-kv_end // TILE)
    return [(s * n // n_split * TILE, min((s + 1) * n // n_split * TILE,
                                          kv_end)) for s in range(n_split)]


def _counters(device, n):
    """The kernel's int32 tickets, one per (b, kv head, row block): a buffer
    kept per device, zeroed once when it is allocated (or grown); every call
    leaves it zero."""
    buf = _counter_buffers.get(device)
    if buf is None or buf.numel() < n:
        buf = _counter_buffers[device] = torch.zeros(
            max(n, 2 * buf.numel() if buf is not None else 256),
            dtype=torch.int32, device=device)
    return buf


_counter_buffers: dict = {}


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
    [B, 1, H, hd] in q's dtype.

    On the card this is one kernel launch.  Its merge of the splits takes
    tickets from a counter buffer kept per device, so calls on one device
    must not run on two streams at once (the port uses one stream).  On
    DTensors the same call runs on the local shards of
    ``flash_attention.local_placements``, ``k_valid`` a host int."""
    if isinstance(q, DTensor):
        pl = local_placements(q, k)
        k_valid = int(k_valid)
        return _local.call(lambda q, k, v: _decode_attention(q, k, v,
                                                              k_valid),
                           (q, k, v), (pl, pl, pl), pl)
    return _decode_attention(q, k, v, k_valid)


def _decode_attention(q, k, v, k_valid):
    B, Sq, H, hd, S, K = check_attention_inputs("decode_attention", q, k, v)
    _build.refuse_grad("decode_attention", "a later training slice (no "
                       "family's training step runs decode-shaped "
                       "attention)", q, k, v)
    if Sq != 1:
        raise ValueError(f"decode_attention: {Sq} query tokens, expected 1")
    k_valid = int(k_valid)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_valid)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kv_end = min(k_valid, S) if k_valid >= 1 else S
    G = H // K
    n_split = plan_splits(B, K, G, kv_end, hd)
    counters = _counters(q.device, B * K * row_blocks(G))
    # one partial (m, l, -, -, acc[hd]) per split and head
    part = torch.empty(n_split * B * H * (hd + 4) if n_split > 1 else 0,
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.launch("decode_attention", "synergai_decode_attention",
                      _ARGTYPES, "synergai_decode_error_string",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), part.data_ptr(), counters.data_ptr(),
                      DTYPES[q.dtype],
                      B, S, H, K, hd, k_valid, kv_end, n_split,
                      1.0 / math.sqrt(hd), stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
