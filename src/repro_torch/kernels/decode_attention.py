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
there is no other path.  On meta tensors it returns the output's shape and
reports the kernel's FLOPs (``_meta``).  ``plan_splits`` sizes the split.
With ``return_lse`` it also returns each row's log-sum-exp and the output
in f32, unrounded: the local step of the sharded flash-decode
(``distributed.sharding.sharded_decode_attention``), which merges shards by
their log-sum-exp.
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

from repro_torch import _meta
from repro_torch.kernels import _build, _local
from repro_torch.kernels.flash_attention import (DTYPES, NEG_INF,
                                                 check_attention_inputs,
                                                 local_placements)

TILE = 32            # keys a stage of the kernel's ring holds
TARGET_CTAS = 264    # two CTAs on each of the H100's 132 SMs
MERGE_BYTES = 96 * 1024  # the partials the last CTA stages in shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 9 + [_F, _P]


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


def _counters(device, stream, n):
    """The kernel's int32 tickets, one per (b, kv head, row block): a buffer
    kept per device and stream, zeroed once when it is allocated (or grown,
    on that stream); every call leaves it zero.  Calls on one stream run in
    order, so they may share it; a call on another stream has its own.
    Only the ``MAX_TICKET_BUFFERS`` last used are kept: a buffer is made on
    its own stream, so the allocator hands its memory out again only in
    that stream's order, after the calls that use it."""
    key = (device, stream)
    buf = _counter_buffers.pop(key, None)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * buf.numel() if buf is not None else 256),
                          dtype=torch.int32, device=device)
    _counter_buffers[key] = buf         # the last used is the last key
    while len(_counter_buffers) > MAX_TICKET_BUFFERS:
        del _counter_buffers[next(iter(_counter_buffers))]
    return buf


MAX_TICKET_BUFFERS = 64
_counter_buffers: dict = {}             # (device, stream) -> tickets


def tickets_at_zero(device) -> bool:
    """Whether every ticket buffer of ``device`` (one a stream) is back at
    zero, as every finished call leaves it."""
    device = torch.device(device)
    return all(not bool(buf.any()) for (dev, _), buf
               in _counter_buffers.items() if dev == device)


def decode_attention_plain(q, k, v, k_valid, return_lse=False):
    """The plain PyTorch version of ``decode_attention`` (one softmax over
    the whole buffer; the same f32 math).  With ``return_lse``: (the output
    in f32, each row's ``torch.logsumexp`` of the scaled, masked scores
    [B, H] f32)."""
    B, _, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    qf = q[:, 0].reshape(B, K, H // K, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qf, k.float()) * (1.0 / math.sqrt(hd))
    masked = torch.arange(S, device=q.device) >= k_valid
    s = s.masked_fill(masked, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v.float()).reshape(B, 1, H, hd)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H)
    return out.to(q.dtype)


def decode_attention(q, k, v, k_valid, return_lse=False):
    """q: [B, 1, H, hd]; k, v: [B, S, K, hd] with H % K == 0, float32 or
    bfloat16, contiguous, on one device; ``k_valid``: the number of valid
    cache positions (an int; a tensor is read back to the host).  Returns
    [B, 1, H, hd] in q's dtype; with ``return_lse``, (that output in f32,
    unrounded, and each row's log-sum-exp of its scaled, masked scores,
    [B, H] f32, natural log).

    On the card this is one kernel launch.  Its merge of the splits takes
    tickets from a counter buffer kept per device and stream, so calls may
    run on several streams at once.  On DTensors the same call runs on the
    local shards of ``flash_attention.local_placements``, ``k_valid`` a host
    int (without ``return_lse``: the sharded flash-decode calls it on its
    local shards itself)."""
    if isinstance(q, DTensor):
        if return_lse:
            raise ValueError("decode_attention: return_lse takes local "
                             "tensors, not DTensors")
        pl = local_placements(q, k)
        k_valid = int(k_valid)
        return _local.call(lambda q, k, v: _decode_attention(q, k, v,
                                                              k_valid),
                           (q, k, v), (pl, pl, pl), pl)
    return _decode_attention(q, k, v, k_valid, return_lse)


def _decode_attention(q, k, v, k_valid, return_lse=False):
    B, Sq, H, hd, S, K = check_attention_inputs("decode_attention", q, k, v)
    _build.refuse_grad("decode_attention", "a later training slice (no "
                       "family's training step runs decode-shaped "
                       "attention)", q, k, v)
    if Sq != 1:
        raise ValueError(f"decode_attention: {Sq} query tokens, expected 1")
    k_valid = int(k_valid)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, k_valid, return_lse)
    kv_end = min(k_valid, S) if k_valid >= 1 else S
    out = torch.empty(q.shape, device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.device.type == "meta":
        # 4 hd a visible key and query head: q.k and p.v
        _meta.kernel_flops("decode_attention", 4 * B * H * kv_end * hd)
        return (out, lse) if return_lse else out
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    G = H // K
    n_split = plan_splits(B, K, G, kv_end, hd)
    # one partial (m, l, -, -, acc[hd]) per split and head
    part = torch.empty(n_split * B * H * (hd + 4) if n_split > 1 else 0,
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = _counters(q.device, stream, B * K * row_blocks(G))
        _build.launch("decode_attention", "synergai_decode_attention",
                      _ARGTYPES, "synergai_decode_error_string",
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(),
                      lse.data_ptr() if lse is not None else None,
                      part.data_ptr(), counters.data_ptr(), DTYPES[q.dtype],
                      B, S, H, K, hd, k_valid, kv_end, n_split,
                      1.0 / math.sqrt(hd), stream)
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0
