#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100 and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, the PyTorch version; build every CUDA
   source in ``src/repro_torch/kernels/csrc`` in parallel (one ``nvcc``
   each), time the build and print ``ptxas``'s register and spill lines
   (every flash instantiation's among them) and each flash kernel's
   tensor-core (``HMMA``) instructions from ``cuobjdump``'s SASS (the bf16
   kernels must have them, the f32 ones none);
2. each kernel against its plain PyTorch version on the card, with the
   kernel's, the plain version's and the bound's milliseconds:
   (a) the v1 and v2 scoring kernels at (J, W) = (2048, 256), (2043, 256),
       (10000, 64) and (16384, 2048) on messy inputs, exactly (every
       output, NaN matched by position);
   (b) the device-resident tick (``tick_score_kernel``, the sort,
       ``greedy_place_kernel``) at (J, cap, W) = (22, 506, 64) (the resident
       main path's mean tick), (2043, 4096, 256), (10000, 16384, 64) and
       (16384, 32768, 2048), energy off and on: inf
       rows and columns, slot -1 padding, doomed rows, f32 ties, NaN, ±inf
       and -0.0 urgencies, K > 1 admission masks; exactly;
   (c) ``flash_attention`` at the serving shape [B, S, H, K, hd] =
       [4, 1024, 32, 8, 128] causal, a ragged danube-like shape (S = 1,000,
       hd 80, window 256) and a gemma-like MQA shape (hd 256, K = 1), the
       profiler showing the tensor-core kernel for bf16 and the FMA kernel
       for f32, and
   (d) ``decode_attention`` on the serving buffer [4, 1064, 32, 8, 128] at
       k_valid 1, 1025 and 1064, a ragged hd-80 buffer and an hd-256 MQA
       buffer; both in f32 (within 2e-5, TF32 off) and bf16 (within one
       bf16 ulp, 2**-7 relative), each beside SDPA as the library yardstick;
   (e) ``rwkv_scan`` at [B, S, H, hd] = [4, 1024, 32, 64] from a zero state
       (the RWKV serving prefill), [4, 1, 32, 64] from a random state (a
       decode step), [2, 1000, 8, 64] from a random state (a ragged length)
       and an hd-16 shape, in f32 inputs (y and the end state within
       1e-5 * max |plain|; bit equality is reported, and expected) and bf16
       inputs (y within one bf16 ulp more), the update in place
       (``state_out=state``) equal to the one out of place;
       no PyTorch call computes the recurrence, so no library yardstick;
   (f) ``moe_routing`` at [T, D, E, k] = [4096, 4096, 16, 2] (the phi3.5
       prefill), [4, 4096, 16, 2] (a decode step), [1, 4096, 16, 2],
       [SWITCH_T, 4096, 16, 2] (the first T of the prefill design),
       [1000, 4000, 16, 2], [4096, 5120, 160, 6] (deepseek-v2), an
       underflowing probability and tied experts, x in bf16 and f32, gates
       and mask bit-equal; no one PyTorch call routes, so the three-call
       sequence (matmul, softmax, topk + scatter) is timed as context; then
       both of the kernel's designs (decode and prefill) at T on each side
       of the switch-over, each bit-equal, with their device times;
3. the scheduling path at full size, on the 10,000-job MMPP scenario over
   the 64-pool fleet ``synth_fleet(8, 28, 28)``: (a) job mode through v1,
   (b) batched with streaming deadlines through v2, and the device-resident
   tick (c) in job mode, (d) batched with streaming deadlines and
   ``energy_weight=0.5``, (e) under ``HierarchicalSynergAI`` over three
   regions of the same fleet on ``regional_scenario``.  Each run counts its
   kernel launches (the counts set to 0 just before it), must give the same
   ``JobResult``s as the same run on the CPU, and is set beside the default
   numpy ``SynergAI()``; the resident runs also print their per-tick
   transfer counters, and one more job-mode resident run over the first
   3,000 jobs times the stages of a device tick;
4. the serving path: qwen3-4b at full width in bf16 (random weights from a
   seed) through ``build_model`` and ``InferenceEngine``, 4 requests of
   batch 4 x prompt 1,024 x 32 generated tokens, each placed by
   ``launch.serve.place`` (Eq. 1-4); the attention launches are counted
   from 0 and must be 36 x 4 flash and 36 x 31 x 4 decode;
5. parity of that path: the same prompts through the kernels and through
   their plain versions (patched in here), in f32 (TF32 off) and bf16, held
   step by step to the logit bounds, with every parting of the greedy
   tokens explained by a near-tie;
6. a decode-step profile: host and device ms, the device's idle share, the
   decode-attention share and the top kernels;
4b-6b. the same for the RWKV family: rwkv6-1.6b at full width in bf16, 4
   requests of batch 4 x prompt 1,024 x 32 generated tokens; the WKV
   launches are counted from 0 and must be 24 x 4 in prefill and
   24 x 31 x 4 in decode, with no attention launch; its parity against
   ``rwkv_scan_plain`` in f32 and bf16, and its decode-step profile with
   the WKV share;
4c-6c. the same for the MoE family: phi3.5-moe-42b-a6.6b at full width
   with its depth cut from 32 to 24 layers (all 32 do not fit the card) in
   bf16, the same 4 requests; the routing launches are counted from 0 and
   must be 24 x 4 in prefill and 24 x 31 x 4 in decode, beside 24 x 4
   flash and 24 x 31 x 4 decode-attention launches and no WKV launch; its
   parity (i) with only the router on its plain version, logits and tokens
   bit-identical, (ii) with all three kernels on their plain versions in
   f32 on the first 4 layers and (iii) in bf16 on all 24, every routing
   call's mask recorded and every step over the bound or parting of tokens
   explained by a near-tie; its decode-step profile with the routing share;
7. the card's floor for one launch (the profiler's device time of a
   one-element ``torch.add``), the kernels at their paths' mean shapes, one
   JSON line with each kernel's launches and times, then the card's line
   from ``nvidia-smi``, then the result.

It needs a CUDA card and a checkout (``src/repro_torch`` beside it), and
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPES = ((2048, 256), (2043, 256), (10000, 64), (16384, 2048))
TICK_SHAPES = ((22, 506, 64), (2043, 4096, 256), (10000, 16384, 64),
               (16384, 32768, 2048))
N_JOBS = 10_000
POOLS = (8, 28, 28)
REPS = 25                 # timed samples per kernel (median reported)
BATCH = 10                # launches per timed sample
TIMES = ("ms", "device_ms", "plain_ms", "bound_ms")

# the attention kernels (B, S, H, K, hd, window): the serving shape, a
# ragged danube-like shape, a gemma-like MQA shape
FLASH_HOLDS = ((4, 1024, 32, 8, 128, None), (4, 1000, 32, 8, 80, 256),
               (2, 2048, 8, 1, 256, None))
# (B, S, H, K, hd, k_valid): the serving buffer (prompt 1,024 + 32 + 8)
# cold, just after the prompt and full; a ragged hd-80 buffer; hd-256 MQA
DECODE_HOLDS = ((4, 1064, 32, 8, 128, 1), (4, 1064, 32, 8, 128, 1025),
                (4, 1064, 32, 8, 128, 1064), (4, 1000, 32, 8, 80, 777),
                (2, 2056, 8, 1, 256, 2050))
# (rtol, atol) of a kernel against its plain version: the same f32 math
# summed in another order; in bf16 both round their f32 result once
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-5)}
# dense peak by input dtype, FLOP/s (NVIDIA's H100 SXM data sheet): bf16
# on the tensor cores; f32 outside them (TF32 would change the numbers)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SERVE_ARCH, REQUESTS, SERVE_BATCH, PROMPT, GEN = "qwen3-4b", 4, 4, 1024, 32
RWKV_ARCH = "rwkv6-1.6b"
# the WKV scan (B, S, H, hd, start state): the RWKV serving prefill (zeros),
# one decode step, a ragged length, the tests' reduced head dim
RWKV_HOLDS = ((4, 1024, 32, 64, False), (4, 1, 32, 64, True),
              (2, 1000, 8, 64, True), (2, 333, 8, 16, True))
# the scan against its plain version: max |delta| <= RWKV_REL * max |plain|
# for y and the end state, bf16 y one bf16 ulp (2**-7 relative) more; the
# two do the same roundings in the same order, so "exact" is expected too
RWKV_REL = 1e-5
# parity: max |logit delta| / max |plain logit| per row and step
LOGIT_BOUND = {"float32": 1e-4, "bfloat16": 3e-2}
# the MoE serving cell: phi3.5-moe at full width, its depth cut from 32 to
# 24 layers (all 32 are 83.7 GB in bf16, more than the card's 80 GB; 24 are
# 62.9 GB), and 4 of them, in f32, for the f32 parity (21.9 GB)
MOE_ARCH, MOE_LAYERS, MOE_F32_LAYERS = "phi3.5-moe-42b-a6.6b", 24, 4
# the router (T, D, E, top_k, case): the phi3.5 prefill (4 x 1,024 tokens),
# one decode step, one token, a ragged shape, the deepseek-v2 shape, a
# probability that underflows (one logit leads by > 110) and tied experts
# (duplicated router columns); held bit for bit (main adds the switch-over)
ROUTING_HOLDS = ((4096, 4096, 16, 2, "random"), (4, 4096, 16, 2, "random"),
                 (1, 4096, 16, 2, "random"),
                 (1000, 4000, 16, 2, "random"), (4096, 5120, 160, 6, "random"),
                 (512, 4096, 16, 2, "underflow"), (512, 4096, 16, 2, "tie"))

# HBM rate by card name, bytes/s (NVIDIA data sheets)
HBM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))

# the f32 boundary tie of tests/test_pallas_parity.py::_tie_inputs: the
# estimate 0.25 + 100 / 2.0 = 50.25 against a float64 budget one ulp below
# it, which float32 rounds back onto the estimate
TIE_EST = 50.25
TIE_REM = float(np.float32(np.nextafter(TIE_EST, 0.0)))


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)


def messy_v1_inputs(J, W, seed):
    """(qps, preproc, queries, t_remaining) as float32: infeasible cells,
    columns and rows (qps <= 0), budgets straddling the estimates, repeated
    estimates (argmin ties), budgets exactly on an estimate, and the f32
    boundary-tie rows."""
    rng = np.random.default_rng(seed)
    qps = rng.choice(np.array([0.5, 1.0, 2.0, 4.0, 8.0], np.float32),
                     size=(J, W))
    qps[rng.random((J, W)) < 0.2] = 0.0
    qps[:, rng.random(W) < 0.1] = 0.0
    qps[rng.random(J) < 0.05] = 0.0
    neg = rng.random(J) < 0.1
    qps[neg] = np.where(rng.random((int(neg.sum()), W)) < 0.5, -1.0,
                        qps[neg])
    pre = rng.choice(np.array([0.0, 0.25, 0.5], np.float32), size=(J, W))
    q = rng.integers(1, 400, J).astype(np.float32)
    est = pre + q[:, None] / np.where(qps > 0, qps, np.float32(1.0))
    rem = (rng.uniform(-5.0, 1.2, J) * est.mean(1)).astype(np.float32)
    on = rng.random(J) < 0.2
    rem[on] = est[on, rng.integers(0, W, int(on.sum()))]
    tie = rng.random(J) < 0.02
    two = min(2, W)
    qps[tie, :two] = np.array([2.0, 1.0])[:two]
    pre[tie, :two] = np.array([0.25, 0.5])[:two]
    q[tie] = 100.0
    rem[tie] = TIE_REM
    return qps, pre, q, rem


def messy_v2_inputs(J, W, seed):
    """(t_solo, prefill, decode, t_remaining, pen, phase, has_ttft, has_tpot,
    ttft_rem, tpot_qos, dtok) as float32 / int32: inf (infeasible) cells,
    columns and rows, mixed phases, pen > 1 on half the workers, streaming
    deadlines on part of the queue, dtok = inf on rows with inf decode cells
    (inf / inf = NaN in the TPOT gate), and the f32 boundary-tie rows."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.5, 200.0, (J, W)).astype(np.float32)
    frac = rng.uniform(0.05, 0.95, (J, W)).astype(np.float32)
    inf = (rng.random((J, W)) < 0.15) | (rng.random(W) < 0.1)[None, :]
    inf[rng.random(J) < 0.05] = True
    t0[inf] = np.inf
    pre_m = t0 * (1 - frac)
    dec_m = t0 * frac
    del frac, inf
    rem = rng.uniform(-20.0, 300.0, J).astype(np.float32)
    pen = np.where(rng.random(W) < 0.5, 1.0 + 0.5 * rng.integers(1, 8, W),
                   1.0).astype(np.float32)
    pen[0] = 1.0
    phase = rng.integers(0, 3, J).astype(np.int32)
    has_ttft = (rng.random(J) < 0.4).astype(np.int32)
    has_tpot = (rng.random(J) < 0.4).astype(np.int32)
    ttft_rem = np.where(has_ttft, rng.uniform(0.5, 80.0, J),
                        np.inf).astype(np.float32)
    tpot_qos = np.where(has_tpot, rng.uniform(1e-4, 1e-2, J),
                        np.inf).astype(np.float32)
    dtok = rng.integers(100, 200_000, J).astype(np.float32)
    dtok[rng.random(J) < 0.1] = np.inf
    tie = rng.random(J) < 0.02
    two = min(2, W)
    for m in (t0, pre_m, dec_m):
        m[tie, :two] = np.array([TIE_EST, 2 * TIE_EST])[:two]
    rem[tie] = TIE_REM
    phase[tie] = has_ttft[tie] = has_tpot[tie] = 0
    return (t0, pre_m, dec_m, rem, pen, phase, has_ttft, has_tpot, ttft_rem,
            tpot_qos, dtok)


def v1_bytes(J, W):
    """Bytes v1 must move: qps, pre read (8 B/cell), est f32 + acc i8
    written (5 B/cell); queries, t_rem read and best, urg written (16 B/row)."""
    return 13 * J * W + 16 * J


def v2_bytes(J, W):
    """Bytes v2 must move: t, pre, dec read (12 B/cell), t_eff f32 + acc i8
    written (5 B/cell); pen read (4 B/worker); seven per-row inputs read and
    urg, doom written (33 B/row)."""
    return 17 * J * W + 4 * W + 33 * J


def bucket(n, block):
    """The device cache's padding: the least power-of-two multiple of
    ``block`` that is >= n."""
    b = block
    while b < n:
        b *= 2
    return b


def f32_uniform(rng, lo, hi, shape):
    return rng.random(shape, dtype=np.float32) * np.float32(hi - lo) + \
        np.float32(lo)


def messy_tick_inputs(J, cap, W, seed, deep=False):
    """The argument list of ``scheduler_tick`` as numpy, padded the way
    ``DeviceScoreCache.device_tick`` pads it (Jp = bucket(J, 128) rows,
    Wp = bucket(W, 128) columns): pools with inf cells, columns and rows,
    rows of four repeated values (f32 ties in the argmin and in the
    urgency order), zero cells; slot -1 padding; budgets that doom rows,
    and +-inf budgets that give +-inf and NaN (inf - inf) urgencies, -0.0
    budgets on zero cells (urgency -0.0); mixed phases and streaming gates;
    K = 4 admission masks, the first admitting no worker; energy rows with a
    few inf cells and zero energy scales (NaN costs).  ``deep`` sends 90 %
    of the rows to the empty mask and opens 95 % of the workers, so the
    greedy walk visits every row; otherwise 60 % of the feasible workers
    open and the walk stops when none is left open."""
    rng = np.random.default_rng(seed)
    Jp, Wp = bucket(J, 128), bucket(W, 128)
    t = np.full((cap, Wp), np.inf, np.float32)
    t[:, :W] = f32_uniform(rng, 0.5, 200.0, (cap, W))
    tied = np.nonzero(rng.random(cap) < 0.1)[0]
    t[tied, :W] = rng.choice(np.array([10, 20, 40, 80], np.float32),
                             (len(tied), W))
    t[rng.random((cap, Wp), dtype=np.float32) < 0.15] = np.inf
    inf_cols = rng.random(Wp) < 0.1
    t[:, inf_cols] = np.inf
    t[rng.random(cap) < 0.05] = np.inf
    slots = np.full(Jp, -1, np.int32)
    slots[:J] = rng.permutation(cap)[:J]
    # queue rows that are sure to hold each hazard: an all-inf row with an
    # inf budget (NaN urgency), inf and -inf budgets, a zero cell with a
    # -0.0 budget (urgency -0.0)
    k = max(1, J // 100) if J >= 4 else 0
    nan_q, pinf_q, ninf_q, zero_q = rng.permutation(J)[:4 * k].reshape(
        4, k)
    t[slots[nan_q]] = np.inf
    t[slots[zero_q], 0] = 0.0
    frac = f32_uniform(rng, 0.05, 0.95, (cap, Wp))
    pre = t * (np.float32(1.0) - frac)
    dec = t * frac
    del frac
    ene = np.where(np.isfinite(t), f32_uniform(rng, 0.1, 50.0, (cap, Wp)),
                   np.float32(np.inf))
    ene[rng.random((cap, Wp), dtype=np.float32) < 0.01] = np.inf

    def rows(values, fill, dtype):
        out = np.full(Jp, fill, dtype)
        out[:J] = values
        return out

    rem = f32_uniform(rng, -20.0, 300.0, J)
    rem[np.isin(slots[:J], tied) & (rng.random(J) < 0.5)] = 60.0
    rem[rng.random(J) < 0.02] = np.inf
    rem[rng.random(J) < 0.01] = -np.inf
    rem[np.concatenate([nan_q, pinf_q])] = np.inf
    rem[ninf_q] = -np.inf
    rem[zero_q] = -0.0
    phase = rng.integers(0, 3, J).astype(np.int32)
    has_ttft = (rng.random(J) < 0.4).astype(np.int32)
    has_tpot = (rng.random(J) < 0.4).astype(np.int32)
    phase[zero_q] = has_ttft[zero_q] = 0
    ttft_rem = np.where(has_ttft, f32_uniform(rng, 0.5, 80.0, J), np.inf)
    tpot_qos = np.where(has_tpot, f32_uniform(rng, 1e-4, 1e-2, J), np.inf)
    dtok = rng.integers(100, 200_000, J).astype(np.float32)
    dtok[rng.random(J) < 0.1] = np.inf
    K = 4
    ekey = rng.integers(1, K, J).astype(np.int32)
    ekey[rng.random(J) < (0.9 if deep else 0.1)] = 0
    emask = np.zeros((K, Wp), bool)
    emask[1:, :W] = rng.random((K - 1, W)) < 0.8

    def cols(values, fill, dtype):
        out = np.full(Wp, fill, dtype)
        out[:W] = values
        return out

    pen = cols(np.where(rng.random(W) < 0.5,
                        1.0 + 0.5 * rng.integers(1, 8, W), 1.0), 1.0,
               np.float32)
    busy_wait = cols(np.where(rng.random(W) < 0.5,
                              rng.uniform(0.0, 100.0, W), 0.0), 0.0,
                     np.float32)
    escale = cols(np.where(rng.random(W) < 0.1, 0.0,
                           rng.uniform(0.0, 1.0, W)), 0.0, np.float32)
    open0 = cols((rng.random(W) < 0.95) if deep
                 else (rng.random(W) < 0.6) & ~inf_cols[:W], False, bool)
    return (t, pre, dec, ene, slots, rows(rem, -1.0, np.float32),
            rows(ttft_rem, -1.0, np.float32), rows(tpot_qos, 1.0, np.float32),
            rows(dtok, 1.0, np.float32), rows(has_ttft, 0, np.int32),
            rows(has_tpot, 0, np.int32), rows(phase, 0, np.int32),
            rows(ekey, 0, np.int32), emask, pen, busy_wait, escale, open0)


def tick_score_bytes(inputs, use_energy):
    """Bytes ``tick_score`` must move: the distinct gathered pool rows of
    t, pre, dec (and ene) read once, ranked f32 written; nine per-row
    inputs read and urg, doom written (41 B/row); pen, busy_wait, escale
    (12 B/worker) and the admission masks read."""
    slots, emask = inputs[4], inputs[13]
    cap, Wp = inputs[0].shape
    Jp = len(slots)
    gathered = len(np.unique(np.clip(slots, 0, cap - 1)))
    return (gathered * Wp * 4 * (4 if use_energy else 3) + Jp * Wp * 4
            + 41 * Jp + 12 * Wp + emask.size)


def walk_steps(assign, order, slots, open0):
    """Rows the greedy walk visits on these inputs: it stops after the
    placement that closes the last open worker, or at the first padded row."""
    valid = int((slots >= 0).sum())
    placed = np.cumsum(assign[order[:valid]] >= 0)
    full = np.nonzero(placed == int(open0.sum()))[0]
    return int(full[0]) + 1 if len(full) else valid


def greedy_bytes(steps, Jp, Wp):
    """Bytes the walk must move: one ranked row and one order and slot
    entry per visited row, the open mask read, assign written."""
    return steps * (Wp * 4 + 8) + Wp + Jp * 4


# ---------------------------------------------------------------------------
# comparison and timing on the card


def exact(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        na, nb = torch.isnan(a), torch.isnan(b)
        return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
    return torch.equal(a, b)


def max_abs_err(outs, refs) -> float:
    import torch
    err = 0.0
    for a, b in zip(outs, refs):
        if a.dtype.is_floating_point:
            d = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
            d = d[~torch.isnan(d)]
            if d.numel():
                err = max(err, float(d.max()))
        else:
            err = max(err, float((a.long() - b.long()).abs().max()))
    return err


def time_ms(fn, reps=REPS, batch=BATCH) -> float:
    """Median over ``reps`` samples of one call's device time, each sample
    timed with CUDA events around ``batch`` back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / batch)
    return statistics.median(samples)


def device_ms(fn, kernel_name, reps=REPS, tries=3, names=None):
    """Device time of one call of ``fn`` in the CUDA kernels whose names
    contain ``kernel_name`` (each kernel's mean over ``reps`` calls, summed
    over the kernels), from the profiler's trace; their full names are
    appended to ``names`` if it is a list.  A trace now and then holds no
    device time for them; it is taken again, up to ``tries`` times, and
    None is returned if none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [evt for evt in prof.key_averages()
                 if kernel_name in evt.key and evt.count
                 and getattr(evt, "device_time_total", 0)]
        if found:
            if names is not None:
                names.extend(sorted(evt.key for evt in found))
            return sum(evt.device_time_total / evt.count / 1e3
                       for evt in found)
    return None


def sass_counts(lib, opcode):
    """Instructions of ``opcode`` in each kernel of the shared library
    ``lib``, by mangled name, from ``cuobjdump -sass``; None where the
    toolkit has no ``cuobjdump``."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    proc = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True)
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def flash_hmma_report():
    """Print each flash kernel's tensor-core instructions (``HMMA`` in the
    SASS); fail if a bf16 kernel has none or an f32 kernel has any.  Their
    registers and spills are ``ptxas``'s lines above."""
    from repro_torch.kernels import _build
    sass = sass_counts(_build.library_path("flash_attention"), "HMMA")
    if sass is None:
        print("  flash: no cuobjdump, tensor-core instructions not counted")
        return
    kinds = set()
    for name, hmma in sorted(sass.items()):
        if "flash_attention_kernel" not in name:
            continue
        mma = "flash_attention_kernel_mma" in name
        if (hmma > 0) != mma:
            raise SystemExit(f"FAIL {name}: {hmma} HMMA instructions")
        kinds.add(mma)
        print(f"  cuobjdump {name}: {hmma} HMMA", flush=True)
    if kinds != {True, False}:
        raise SystemExit("FAIL flash: the SASS lacks the mma or the fma "
                         "kernels")


def to_card(arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def hold_kernel(name, wrapper, plain, inputs, nbytes, rate, kernel_name,
                slow=False):
    """Run ``wrapper`` (the kernel) and ``plain`` on the same card inputs,
    fail unless every output is identical, and time both: ``ms`` and
    ``plain_ms`` per call with CUDA events (host overhead included where
    it exceeds the device time), ``device_ms`` the kernel alone.  ``slow``
    times the plain version over 3 single calls (a Python loop)."""
    import torch
    out = wrapper(*inputs)
    ref = plain(*inputs)
    torch.cuda.synchronize()
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    ok = all(exact(a, b) for a, b in zip(out, ref))
    err = max_abs_err(out, ref)
    if not ok:
        raise SystemExit(f"FAIL {name}: kernel and plain version differ "
                         f"(max abs err {err})")
    ms = time_ms(lambda: wrapper(*inputs), batch=1 if slow else BATCH)
    plain_ms = time_ms(lambda: plain(*inputs), *((3, 1) if slow else ()))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms(lambda: wrapper(*inputs), kernel_name),
            "bound_ms": nbytes / rate * 1e3}


def hold_tick(inputs, use_energy, rate):
    """Hold the device-resident tick on the card: ``tick_score`` against
    its plain version (ranked, urg, doom), ``greedy_place`` against its
    plain version on the same order, and ``scheduler_tick`` whole against
    ``scheduler_tick_plain`` (assign, order).  Returns each kernel's hold
    record and the rows the walk visited."""
    import torch
    from repro_torch.kernels import scheduler_score as ss
    dev = to_card(inputs)
    score_in = dev[:17]
    slots, open0 = dev[4], dev[17]
    score = hold_kernel(
        "tick_score_kernel",
        lambda *a: ss.tick_score(*a, use_energy=use_energy),
        lambda *a: ss.tick_score_plain(*a, use_energy=use_energy),
        score_in, tick_score_bytes(inputs, use_energy), rate,
        "tick_score_kernel")
    ranked, urg, doom = ss.tick_score_plain(*score_in, use_energy=use_energy)
    order = ss.tick_order(urg, doom, slots)
    walk_in = (ranked, order, slots, open0)
    assign = ss.greedy_place_plain(*walk_in)
    steps = walk_steps(assign.cpu().numpy(), order.cpu().numpy(),
                       inputs[4], inputs[17])
    Jp, Wp = ranked.shape
    walk = hold_kernel("greedy_place_kernel", ss.greedy_place,
                       ss.greedy_place_plain, walk_in,
                       greedy_bytes(steps, Jp, Wp), rate,
                       "greedy_place_kernel", slow=True)
    whole = ss.scheduler_tick(*dev, use_energy=use_energy)
    want = ss.scheduler_tick_plain(*dev, use_energy=use_energy)
    torch.cuda.synchronize()
    if not all(exact(a, b) for a, b in zip(whole, want)):
        raise SystemExit("FAIL scheduler_tick: kernels and plain version "
                         "differ")
    if not exact(want[0], assign):
        raise SystemExit("FAIL scheduler_tick_plain: assign differs from "
                         "its own parts")
    return score, walk, steps


# ---------------------------------------------------------------------------
# the main path


def canon(results):
    """Every JobResult field but the host wall-clock ``decision_s``."""
    out = []
    for r in results:
        d = dataclasses.asdict(r)
        d.pop("decision_s")
        out.append(json.dumps(d, sort_keys=True, default=str))
    return out


def drive(cd, jobs, fleet, serving, policy):
    """One simulator run of ``policy``; returns (results, per-call
    schedule seconds, wall seconds)."""
    from repro_torch.core.simulator import Simulator
    inner = policy.schedule
    ticks = []

    def schedule(now, queue, cluster):
        t0 = time.perf_counter()
        out = inner(now, queue, cluster)
        ticks.append(time.perf_counter() - t0)
        return out

    policy.schedule = schedule
    sim = Simulator(cd, policy, fleet=fleet, seed=0, serving=serving)
    t0 = time.perf_counter()
    results = sim.run(jobs)
    return results, ticks, time.perf_counter() - t0


def synergai(score_fn):
    from repro_torch.core.scheduler import SynergAI
    return SynergAI(score_fn=score_fn)


def main_path_run(label, cd, fleet, serving, streaming, v2, kernel):
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.core.workload import scenario
    jobs = scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet, seed=0,
                    serving=serving, streaming=streaming)
    res_np, ticks_np, wall_np = drive(cd, jobs, fleet, serving,
                                      synergai(None))

    card_fn = make_torch_score_fn(v2=v2)
    kernel.launches = 0
    res_card, ticks_card, wall_card = drive(cd, jobs, fleet, serving,
                                            synergai(card_fn))
    launches = kernel.launches

    cpu_fn = make_torch_score_fn(v2=v2, device="cpu")
    res_cpu, _, wall_cpu = drive(cd, jobs, fleet, serving, synergai(cpu_fn))
    if kernel.launches != launches:
        raise SystemExit(f"FAIL {label}: the CPU run launched a kernel")

    if launches <= 0 or launches < card_fn.calls:
        raise SystemExit(f"FAIL {label}: {launches} launches for "
                         f"{card_fn.calls} scoring ticks")
    if canon(res_card) != canon(res_cpu):
        raise SystemExit(f"FAIL {label}: card results differ from the "
                         "device='cpu' run")
    if len(res_card) != N_JOBS:
        raise SystemExit(f"FAIL {label}: {len(res_card)} results")
    placed = {r.job.id: (r.worker, r.config) for r in res_card}
    differ = sum(placed[r.job.id] != (r.worker, r.config) for r in res_np)
    s_np, s_card = summarize(res_np), summarize(res_card)
    if not all(math.isfinite(s_card[k]) for k in ("e2e_avg_s",
                                                  "goodput_jps")):
        raise SystemExit(f"FAIL {label}: non-finite summary {s_card}")
    calls = max(card_fn.calls, 1)
    split = {k: v / calls * 1e3 for k, v in card_fn.seconds.items()}
    line = {
        "run": label, "jobs": len(res_card), "pools": len(fleet),
        "launches": launches, "scoring_ticks": card_fn.calls,
        "mean_rows_per_tick": card_fn.rows / calls,
        "identical_to_cpu_run": True,
        "placements_differing_from_numpy": differ,
        "violations": {"numpy": s_np["violations"],
                       "card": s_card["violations"]},
        "goodput_jps": {"numpy": s_np["goodput_jps"],
                        "card": s_card["goodput_jps"]},
        "wall_s": {"numpy": wall_np, "card": wall_card, "cpu": wall_cpu},
        "schedule_calls": len(ticks_card),
        "schedule_ms_per_call": {"numpy": statistics.fmean(ticks_np) * 1e3,
                                 "card": statistics.fmean(ticks_card) * 1e3},
        "card_scoring_ms_per_tick": split,
    }
    print("main_path " + json.dumps(line), flush=True)
    return launches, card_fn.rows / calls


def caches_of(policy):
    """The device caches of a flat or hierarchical resident policy."""
    subs = getattr(policy, "_subs", None)
    return ([sub.cache for sub in subs.values()] if subs is not None
            else [policy.cache])


def resident_run(label, cd, fleet, jobs, serving, make_policy):
    """The device-resident path: ``make_policy(score_fn)`` on the card, on
    the CPU and with the numpy default (``score_fn=None``).  Returns the
    launches of each tick kernel and the mean (J, cap) of the card's
    ticks."""
    from repro_torch.core import devicecache
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.kernels import scheduler_score as ss
    res_np, ticks_np, wall_np = drive(cd, jobs, fleet, serving,
                                      make_policy(None))

    # per device_tick: queue length, pool rows, host-clock seconds
    tick_log = []
    inner = devicecache.DeviceScoreCache.device_tick

    def device_tick(self, slots, *args, **kw):
        t0 = time.perf_counter()
        out = inner(self, slots, *args, **kw)
        tick_log.append((len(slots), self._d_cap, time.perf_counter() - t0))
        return out

    card_pol = make_policy(make_torch_score_fn(device_cache=True))
    devicecache.DeviceScoreCache.device_tick = device_tick
    try:
        ss.tick_score.launches = ss.greedy_place.launches = 0
        res_card, ticks_card, wall_card = drive(cd, jobs, fleet, serving,
                                                card_pol)
        launches = {"tick_score_kernel": ss.tick_score.launches,
                    "greedy_place_kernel": ss.greedy_place.launches}
    finally:
        devicecache.DeviceScoreCache.device_tick = inner

    cpu_pol = make_policy(make_torch_score_fn(device_cache=True,
                                              device="cpu"))
    res_cpu, _, wall_cpu = drive(cd, jobs, fleet, serving, cpu_pol)
    if (ss.tick_score.launches, ss.greedy_place.launches) != tuple(
            launches.values()):
        raise SystemExit(f"FAIL {label}: the CPU run launched a kernel")

    caches = caches_of(card_pol)
    ticks = sum(c.ticks for c in caches)
    if ticks <= 0 or any(n != ticks for n in launches.values()):
        raise SystemExit(f"FAIL {label}: launches {launches} for {ticks} "
                         "device ticks")
    if canon(res_card) != canon(res_cpu):
        raise SystemExit(f"FAIL {label}: card results differ from the "
                         "device='cpu' run")
    cpu_caches = caches_of(cpu_pol)
    for key in ("ticks", "rows_uploaded", "bytes_to_device", "fail_masks",
                "flushes"):
        if (sum(getattr(c, key) for c in caches)
                != sum(getattr(c, key) for c in cpu_caches)):
            raise SystemExit(f"FAIL {label}: counter {key} differs from the "
                             "device='cpu' run")
    if len(res_card) != len(jobs):
        raise SystemExit(f"FAIL {label}: {len(res_card)} results")
    placed = {r.job.id: (r.worker, r.config) for r in res_card}
    differ = sum(placed[r.job.id] != (r.worker, r.config) for r in res_np)
    s_np, s_card = summarize(res_np), summarize(res_card)
    if not all(math.isfinite(s_card[k]) for k in ("e2e_avg_s",
                                                  "goodput_jps")):
        raise SystemExit(f"FAIL {label}: non-finite summary {s_card}")
    mean_j = statistics.fmean(j for j, _, _ in tick_log)
    mean_cap = statistics.fmean(c for _, c, _ in tick_log)
    line = {
        "run": label, "jobs": len(res_card), "pools": len(fleet),
        "caches": len(caches), "launches": launches, "device_ticks": ticks,
        "mean_rows_per_tick": mean_j, "mean_pool_rows": mean_cap,
        "identical_to_cpu_run": True,
        "placements_differing_from_numpy": differ,
        "violations": {"numpy": s_np["violations"],
                       "card": s_card["violations"]},
        "goodput_jps": {"numpy": s_np["goodput_jps"],
                        "card": s_card["goodput_jps"]},
        "wall_s": {"numpy": wall_np, "card": wall_card, "cpu": wall_cpu},
        "schedule_calls": len(ticks_card),
        "schedule_ms_per_call": {"numpy": statistics.fmean(ticks_np) * 1e3,
                                 "card": statistics.fmean(ticks_card) * 1e3},
        "device_tick_ms": statistics.fmean(t for _, _, t in tick_log) * 1e3,
        "bytes_to_device_per_tick":
            sum(c.bytes_to_device for c in caches) / ticks,
        "rows_uploaded": sum(c.rows_uploaded for c in caches),
        "fail_masks": sum(c.fail_masks for c in caches),
        "flushes": sum(c.flushes for c in caches),
    }
    print("main_path " + json.dumps(line), flush=True)
    return launches, mean_j, mean_cap


def tick_stages(cd, fleet, jobs):
    """Where a device tick's host time goes: one more job-mode resident run
    with the device synchronised around each stage of ``device_tick``:
    the packed copy of the tick's vectors (``ship``), the whole
    ``scheduler_tick`` and, inside it, the sort (``order``); ``rest`` is the
    padding on the host and the one readback.  Returns mean ms per tick."""
    import torch
    from repro_torch.core import devicecache
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.kernels import scheduler_score as ss
    seconds = dict(device_tick=0.0, ship=0.0, upload=0.0,
                   scheduler_tick=0.0, order=0.0)
    inside = []         # non-empty while device_tick runs

    def timed(name, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inside.append(name)
            try:
                out = fn(*args, **kw)
            finally:
                inside.pop()
            torch.cuda.synchronize()
            key = "upload" if name == "ship" and not inside else name
            seconds[key] += time.perf_counter() - t0
            return out
        return run

    saved = (devicecache.DeviceScoreCache.device_tick, devicecache._ship,
             devicecache.scheduler_tick, ss.tick_order)
    policy = synergai(make_torch_score_fn(device_cache=True))
    try:
        devicecache.DeviceScoreCache.device_tick = timed("device_tick",
                                                         saved[0])
        devicecache._ship = timed("ship", saved[1])
        devicecache.scheduler_tick = timed("scheduler_tick", saved[2])
        ss.tick_order = timed("order", saved[3])
        drive(cd, jobs, fleet, "job", policy)
    finally:
        (devicecache.DeviceScoreCache.device_tick, devicecache._ship,
         devicecache.scheduler_tick, ss.tick_order) = saved
    ticks = policy.cache.ticks
    ms = {k: v / ticks * 1e3 for k, v in seconds.items()}
    split = {"ship (one packed copy of the tick's vectors)": ms["ship"],
             "tick_score + greedy_place (wrappers, launches, kernels)":
                 ms["scheduler_tick"] - ms["order"],
             "order (sort key and sort)": ms["order"],
             "rest (host padding, one readback)":
                 ms["device_tick"] - ms["scheduler_tick"] - ms["ship"],
             "row uploads in sync, outside device_tick": ms["upload"]}
    line = {"run": "job-resident, staged", "jobs": len(jobs),
            "device_ticks": ticks, "device_tick_ms": ms["device_tick"],
            "split_ms": split}
    print("tick_stages " + json.dumps(line), flush=True)


# ---------------------------------------------------------------------------
# the attention kernels


def attn_inputs(q_shape, kv_shape, dtype, seed):
    """q, k, v on the card: standard normal from a numpy seed, cast."""
    import torch
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device="cuda", dtype=dtype) for s in (q_shape, kv_shape,
                                                     kv_shape)]


def visible_pairs(Sq, Sk, causal, window):
    """(query, key) pairs that the masks leave visible, per head."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= q - k < window
    return int(ok.sum())


def attn_bound(ops, nbytes, dtype_name, rate):
    """(bound_ms, bound_by): the larger of the operations over the dtype's
    dense peak and the bytes over the HBM rate."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype_name], nbytes / rate
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def hold_attention(label, kernel_name, wrapper, plain, library, inputs,
                   dtype_name, ops, nbytes, rate):
    """Run the kernel and its plain version on the same card inputs, fail
    unless every output element is within ``ATTN_TOL``, and time the
    kernel (per call and device), the plain version and ``library`` (one
    PyTorch call of the same function, never used by the port)."""
    import torch
    out = wrapper(*inputs)
    want = plain(*inputs)
    lib = library(*inputs)
    torch.cuda.synchronize()
    rtol, atol = ATTN_TOL[dtype_name]
    err = (out.float() - want.float()).abs()
    bad = int((err > atol + rtol * want.float().abs()).sum())
    if bad or not bool(torch.isfinite(out).all()):
        raise SystemExit(f"FAIL {label}: {bad} elements outside rtol {rtol}, "
                         f"atol {atol} (max abs err {float(err.max())})")
    bound_ms, bound_by = attn_bound(ops, nbytes, dtype_name, rate)
    names = []
    r = {"max_abs_err": float(err.max()), "rtol": rtol, "atol": atol,
         "ms": time_ms(lambda: wrapper(*inputs)),
         "device_ms": device_ms(lambda: wrapper(*inputs), kernel_name,
                                names=names),
         "plain_ms": time_ms(lambda: plain(*inputs), reps=5, batch=2),
         "library_ms": time_ms(lambda: library(*inputs)),
         "library_max_abs_err": float((lib.float() - want.float()).abs()
                                      .max()),
         "bound_ms": bound_ms, "bound_by": bound_by, "kernels": names}
    print(f"hold {label}: within tolerance, " + json.dumps(r), flush=True)
    return r


def hold_flash(B, S, H, K, hd, window, dtype_name, rate):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dtype = getattr(torch, dtype_name)
    inputs = attn_inputs((B, S, H, hd), (B, S, K, hd), dtype, S + hd)
    ok = None
    if window is not None:
        pos = torch.arange(S, device="cuda")
        ok = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                               < window)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=ok, is_causal=ok is None,
            enable_gqa=True).transpose(1, 2)

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=True, window=window)

    esize = inputs[0].element_size()
    label = (f"flash_attention (B, S, H, K, hd, window)="
             f"{(B, S, H, K, hd, window)} {dtype_name}")
    r = hold_attention(
        label, "flash_attention_kernel", kernel,
        lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=True,
                                                 window=window),
        sdpa, inputs, dtype_name,
        4 * B * H * visible_pairs(S, S, True, window) * hd,
        esize * (2 * B * S * H * hd + 2 * B * S * K * hd), rate)
    # bf16 runs on the tensor cores, f32 on the FMA kernel, by dtype (the
    # names from the trace that timed it)
    want = ("flash_attention_kernel_mma" if dtype_name == "bfloat16"
            else "flash_attention_kernel_fma")
    if (r["device_ms"] is None or not r["kernels"]
            or any(want not in n for n in r["kernels"])):
        raise SystemExit(f"FAIL {label}: launched {r['kernels']}, not {want}")
    return r


def hold_decode(B, S, H, K, hd, k_valid, dtype_name, rate, label=""):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    dtype = getattr(torch, dtype_name)
    q, k, v = attn_inputs((B, 1, H, hd), (B, S, K, hd), dtype, S + hd)
    kv_end = min(k_valid, S)

    def sdpa(q, k, v, k_valid):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :kv_end].transpose(1, 2),
            v[:, :kv_end].transpose(1, 2), enable_gqa=True).transpose(1, 2)

    esize = q.element_size()
    return hold_attention(
        f"decode_attention{label} (B, S, H, K, hd, k_valid)="
        f"{(B, S, H, K, hd, k_valid)} {dtype_name}", "decode_attention_",
        da.decode_attention, da.decode_attention_plain, sdpa,
        (q, k, v, k_valid), dtype_name, 4 * B * H * kv_end * hd,
        esize * (2 * B * kv_end * K * hd + 2 * B * H * hd), rate)


def rwkv_inputs(B, S, H, hd, dtype, seed, with_state):
    """r, k, v, w [B, S, H, hd] in ``dtype`` and u [H, hd] f32 on the card,
    standard normal from a numpy seed (w = exp(-exp(.)) in (0, 1), as the
    layer makes it), and a standard-normal f32 start state or None."""
    import torch
    rng = np.random.default_rng(seed)
    shape = (B, S, H, hd)
    rkv = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    w = np.exp(-np.exp(rng.standard_normal(shape, dtype=np.float32)))
    card = [torch.from_numpy(a).to(device="cuda", dtype=dtype)
            for a in rkv + [w]]
    card.append(torch.from_numpy(rng.standard_normal(
        (H, hd), dtype=np.float32)).cuda())
    state = (torch.from_numpy(rng.standard_normal(
        (B, H, hd, hd), dtype=np.float32)).cuda() if with_state else None)
    return card, state


def rwkv_held(y, s, y_plain, s_plain):
    """(max abs err over y and the end state, whether both are within the
    tolerance of ``RWKV_REL``)."""
    import torch
    yp = y_plain.float()
    dy = (y.float() - yp).abs()
    lim = RWKV_REL * float(yp.abs().max()) if yp.numel() else 0.0
    if y.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * yp.abs()
    ds = (s - s_plain).abs()
    ok = (bool(torch.isfinite(y).all()) and bool((dy <= lim).all())
          and float(ds.max()) <= RWKV_REL * float(s_plain.abs().max()))
    return max(float(dy.max()) if dy.numel() else 0.0, float(ds.max())), ok


def rwkv_bound(B, S, H, hd, esize, with_state, dtype_name, rate):
    """(bound_ms, bound_by) of one scan: r, k, v, w read and y written once,
    u and the start state (if given) read, the end state written; about
    6 * hd**2 operations per step and (batch, head)."""
    nbytes = (5 * B * S * H * hd * esize + 4 * H * hd
              + 4 * B * H * hd * hd * (2 if with_state else 1))
    return attn_bound(6 * hd * hd * B * S * H, nbytes, dtype_name, rate)


def hold_rwkv(B, S, H, hd, with_state, dtype_name, rate):
    """``rwkv_scan`` against ``rwkv_scan_plain`` on the same card inputs,
    its update in place against the one out of place, and the times."""
    import torch
    from repro_torch.kernels import rwkv_scan as rs
    dtype = getattr(torch, dtype_name)
    ins, state = rwkv_inputs(B, S, H, hd, dtype, S + hd, with_state)
    label = (f"rwkv_scan (B, S, H, hd)={(B, S, H, hd)} "
             f"{'from a random' if with_state else 'from a zero'} state "
             f"{dtype_name}")
    y, s = rs.rwkv_scan(*ins, state)
    y_plain, s_plain = rs.rwkv_scan_plain(*ins, state)
    inplace = (state.clone() if with_state else
               torch.zeros((B, H, hd, hd), device="cuda"))
    y2, s2 = rs.rwkv_scan(*ins, inplace, state_out=inplace)
    torch.cuda.synchronize()
    if s2 is not inplace or not torch.equal(inplace, s) or not torch.equal(
            y2, y):
        raise SystemExit(f"FAIL {label}: the update in place differs from "
                         "the one out of place")
    err, ok = rwkv_held(y, s, y_plain, s_plain)
    if not ok:
        raise SystemExit(f"FAIL {label}: outside the tolerance (max abs err "
                         f"{err})")
    bound_ms, bound_by = rwkv_bound(B, S, H, hd, y.element_size(),
                                    with_state, dtype_name, rate)
    r = {"max_abs_err": err, "exact": torch.equal(y, y_plain)
         and torch.equal(s, s_plain),
         "max_abs_y_plain": float(y_plain.float().abs().max()),
         "rel": RWKV_REL,
         "ms": time_ms(lambda: rs.rwkv_scan(*ins, state)),
         "device_ms": device_ms(lambda: rs.rwkv_scan(*ins, state),
                                "rwkv_scan_kernel"),
         "plain_ms": time_ms(lambda: rs.rwkv_scan_plain(*ins, state), reps=3,
                             batch=1),
         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"hold {label}: within tolerance, in place = out of place, "
          + json.dumps(r), flush=True)
    return r


def routing_inputs(T, D, E, dtype, seed, case="random", device="cuda"):
    """x [T, D] in ``dtype`` (standard normal) and the router [D, E] f32
    (normal with std 1/sqrt(D), as the model draws it) on ``device``, from
    a numpy seed.  "underflow": x[:, 0] = 1 and W[0, 0] = 120, so logit 0
    leads by > 110 and every other probability underflows to 0 in f32;
    "tie": experts 7 and 12 copy expert 1's column, which leads."""
    import torch
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D), dtype=np.float32)
    w = (rng.standard_normal((D, E)) / math.sqrt(D)).astype(np.float32)
    if case == "underflow":
        x[:, 0] = 1.0
        w[0, 0] = 120.0
    elif case == "tie":
        x[:, 0] = 1.0
        w[0, 1] = 12.0
        w[:, 7] = w[:, 12] = w[:, 1]
    return (torch.from_numpy(x).to(device=device, dtype=dtype),
            torch.from_numpy(w).to(device))


def routing_held(gates, mask, gates_plain, mask_plain, top_k, case):
    """Whether the kernel's gates and mask equal the plain version's bit
    for bit, every row has k picks, and the constructed cases came out as
    built (the underflow rows pick k experts though fewer than k gates are
    > 0; the tied experts 1 and 7 are picked before 12)."""
    import torch
    ok = (torch.equal(gates, gates_plain) and torch.equal(mask, mask_plain)
          and bool(torch.isfinite(gates).all())
          and bool((mask.sum(-1) == top_k).all()))
    if case == "underflow":
        ok = ok and bool(((gates > 0).sum(-1) < top_k).all())
    if case == "tie":
        ok = ok and bool((mask[:, [1, 7]] == 1).all()) and not bool(
            mask[:, 12].any())
    return ok


def hold_routing(T, D, E, top_k, case, dtype_name, rate):
    """``moe_routing`` against ``moe_routing_plain`` on the same card
    inputs, bit for bit, and the times: the kernel per call and on the
    device, the plain version, and (as context only, no one PyTorch call
    computes the function) the three-call sequence x.float() @ W, softmax,
    topk + scatter."""
    import torch
    from repro_torch.kernels import moe_routing as mr
    x, w = routing_inputs(T, D, E, getattr(torch, dtype_name), T + D + E,
                          case)
    label = (f"moe_routing (T, D, E, k)={(T, D, E, top_k)} {case} "
             f"x {dtype_name}")
    gates, mask = mr.moe_routing(x, w, top_k)
    gates_plain, mask_plain = mr.moe_routing_plain(x, w, top_k)
    torch.cuda.synchronize()
    if not routing_held(gates, mask, gates_plain, mask_plain, top_k, case):
        raise SystemExit(f"FAIL {label}: the kernel and its plain version "
                         "differ (max abs gate err "
                         f"{float((gates - gates_plain).abs().max())}, "
                         f"{int((mask != mask_plain).sum())} mask entries)")

    def sequence():
        probs = torch.softmax(x.float() @ w, dim=-1)
        vals, idx = probs.topk(top_k, dim=-1)
        return torch.zeros_like(probs).scatter_(1, idx, vals)

    nbytes = x.numel() * x.element_size() + w.numel() * 4 + 2 * T * E * 4
    bound_ms, bound_by = attn_bound(2 * T * D * E, nbytes, "float32", rate)
    r = {"max_abs_err": float((gates - gates_plain).abs().max()),
         "exact": True,
         "ms": time_ms(lambda: mr.moe_routing(x, w, top_k)),
         "device_ms": device_ms(lambda: mr.moe_routing(x, w, top_k),
                                "moe_routing_kernel"),
         "plain_ms": time_ms(lambda: mr.moe_routing_plain(x, w, top_k),
                             reps=3, batch=1),
         "library_ms": None, "three_call_ms": time_ms(sequence),
         "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"hold {label}: bit-equal, " + json.dumps(r), flush=True)
    return r


def router_designs(T, D, E, top_k, rate):
    """Both of the router kernel's designs at [T, D, E, top_k], x in bf16:
    each bit-equal to the plain version, and each one's device time."""
    import torch
    from repro_torch.kernels import moe_routing as mr
    x, w = routing_inputs(T, D, E, torch.bfloat16, T + D + E)
    gates_plain, mask_plain = mr.moe_routing_plain(x, w, top_k)
    r = {"picked": "decode" if T < mr.SWITCH_T else "prefill"}
    for design in ("decode", "prefill"):
        gates, mask = mr.moe_routing(x, w, top_k, design=design)
        torch.cuda.synchronize()
        if not routing_held(gates, mask, gates_plain, mask_plain, top_k,
                            "random"):
            raise SystemExit(f"FAIL moe_routing {design} design at "
                             f"{(T, D, E, top_k)}: differs from the plain "
                             "version")
        r[f"{design}_device_ms"] = device_ms(
            lambda: mr.moe_routing(x, w, top_k, design=design),
            "moe_routing_kernel")
    nbytes = x.numel() * 2 + w.numel() * 4 + 2 * T * E * 4
    r["bound_ms"] = attn_bound(2 * T * D * E, nbytes, "float32", rate)[0]
    print(f"router designs (T, D, E, k)={(T, D, E, top_k)}: bit-equal, "
          + json.dumps(r), flush=True)
    return r


def launch_floor_ms():
    """The card's floor for one launch: the profiler's device time of
    ``torch.add`` on two one-element f32 tensors."""
    import torch
    one = torch.zeros(1, device="cuda")
    return device_ms(lambda: torch.add(one, one), "elementwise_kernel")


# ---------------------------------------------------------------------------
# the serving path


def launch_counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def serve_run(model, params, prompts, wrappers, want_prefill, want_decode):
    """Serve ``prompts`` through ``InferenceEngine``, each request placed by
    the serving launcher's Eq. 1-4 plan.  The launch counts of ``wrappers``
    are set to 0 just before and read just after, and held to
    ``want_prefill`` (counted inside ``Model.prefill``) and ``want_decode``
    (the rest)."""
    import torch
    from repro_torch.core.offline import characterize
    from repro_torch.launch.serve import place
    from repro_torch.serving.engine import InferenceEngine
    arch = model.cfg.name
    cd = characterize()
    in_prefill = {name: 0 for name in wrappers}

    def prefill(p, batch):
        before = launch_counts(wrappers)
        out = model.prefill(p, batch)
        for name, n in launch_counts(wrappers).items():
            in_prefill[name] += n - before[name]
        return out

    eng = InferenceEngine(dataclasses.replace(model, prefill=prefill),
                          params, max_len=PROMPT + GEN + 8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    for rid, toks in enumerate(prompts):
        plan = place(cd, arch, rid)
        pre, dec = eng.stats.prefill_s, eng.stats.decode_s
        out = eng.generate({"tokens": toks}, GEN)
        pre, dec = eng.stats.prefill_s - pre, eng.stats.decode_s - dec
        if out.shape != (SERVE_BATCH, GEN) or not bool(
                ((out >= 0) & (out < model.cfg.vocab)).all()):
            raise SystemExit(f"FAIL serve {arch}: tokens {tuple(out.shape)} "
                             "out of range")
        print("serve " + json.dumps({
            "arch": arch, "request": rid, "worker": plan,
            "batch": SERVE_BATCH, "prompt": PROMPT, "generated": GEN,
            "prefill_s": pre, "decode_s": dec,
            "tokens_per_s": SERVE_BATCH * GEN / (pre + dec),
            "decode_tokens_per_s": SERVE_BATCH * (GEN - 1) / dec}),
            flush=True)
    launches = launch_counts(wrappers)
    got = {"prefill": in_prefill,
           "decode": {k: launches[k] - in_prefill[k] for k in launches}}
    want = {"prefill": want_prefill, "decode": want_decode}
    s = eng.stats
    print("serving " + json.dumps({
        "arch": arch, "dtype": model.cfg.dtype, "layers": model.cfg.n_layers,
        "d_model": model.cfg.d_model, "requests": REQUESTS,
        "launches": launches, "launches_by_phase": got,
        "expected_launches_by_phase": want,
        "prefill_s": s.prefill_s / REQUESTS, "decode_s": s.decode_s / REQUESTS,
        "tokens_per_s": s.decoded_tokens / (s.prefill_s + s.decode_s),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "cache_gb": eng.cache_footprint(SERVE_BATCH) / 1e9}), flush=True)
    if got != want:
        raise SystemExit(f"FAIL serve {arch}: launches {got}, expected "
                         f"{want}")
    return launches


def traced_generate(model, params, toks):
    """Greedy generation through ``InferenceEngine`` that keeps each step's
    logits (the prefill's, then each decode step's) as f32."""
    import torch
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.sampling import greedy
    steps = []

    def record(logits, generator=None):
        steps.append(logits.float())
        return greedy(logits)

    out = InferenceEngine(model, params, max_len=PROMPT + GEN + 8,
                          sampler=record).generate({"tokens": toks}, GEN)
    return torch.stack(steps), out


def parity(model, params, toks, dtype_name, wrappers, plains):
    """The same prompts through the kernels and through their plain
    versions (``plains``: the names the model looks up, patched to the
    plain versions), held step by step: max |delta| / max |plain| of each
    row's logits within ``LOGIT_BOUND``; a row is compared up to its first
    parting of tokens, and a parting is explained only where the plain
    run's top-2 gap is no larger than max |delta logit| at that step.
    ``wrappers``: the kernels whose launch counts show which run is which."""
    from contextlib import ExitStack
    counts = launch_counts(wrappers)
    logits_k, toks_k = traced_generate(model, params, toks)
    if launch_counts(wrappers) == counts:
        raise SystemExit("FAIL parity: the kernel run launched no kernel")
    counts = launch_counts(wrappers)
    with ExitStack() as stack:
        for target, plain in plains.items():
            stack.enter_context(mock.patch(target, plain))
        logits_p, toks_p = traced_generate(model, params, toks)
    if launch_counts(wrappers) != counts:
        raise SystemExit("FAIL parity: the plain run launched a kernel")
    bound = LOGIT_BOUND[dtype_name]
    equal, partings, worst, over = 0, [], 0.0, []
    T, B = logits_p.shape[:2]
    for b in range(B):
        for t in range(T):
            plain, delta = logits_p[t, b], (logits_k[t, b] - logits_p[t, b])
            dmax = float(delta.abs().max())
            rel = dmax / float(plain.abs().max())
            worst = max(worst, rel)
            if rel > bound:
                over.append({"row": b, "step": t, "rel": rel})
            if int(toks_k[b, t]) != int(toks_p[b, t]):
                top2 = plain.topk(2).values
                gap = float(top2[0] - top2[1])
                partings.append({"row": b, "step": t, "gap": gap,
                                 "max_abs_dlogit": dmax,
                                 "explained": gap <= dmax})
                break
            equal += 1
    line = {"arch": model.cfg.name, "dtype": dtype_name, "rows": B,
            "steps": T, "equal_tokens": equal, "bound": bound,
            "worst_rel_delta": worst, "partings": partings,
            "over_bound": over}
    print("parity " + json.dumps(line), flush=True)
    if over or any(not p["explained"] for p in partings):
        raise SystemExit(f"FAIL parity {model.cfg.name} {dtype_name}: "
                         f"{len(over)} steps over the bound or an "
                         "unexplained parting")
    return line


def routing_recorder(route, log):
    """``route`` (the router's kernel or plain version), recording each
    call's mask and (for the near-tie check) its f32 probabilities."""
    import torch

    def recorded(x, router_w, top_k):
        gates, mask = route(x, router_w, top_k)
        log.append((mask.bool(), torch.softmax(x.float() @ router_w, -1)))
        return gates, mask
    return recorded


def first_routing_partings(log_k, log_p, rows, layers, top_k):
    """Per batch row, the first routing decision (call, token) whose mask
    differs between the two runs, with the plain run's gap between its
    k-th and (k+1)-th probability and max |delta prob| of that token, and
    whether it is a near-tie: a gap no larger than 2 max |delta prob|, as
    far as the two probabilities can close it; and the count of differing
    decisions."""
    import torch
    first, n_diff = {}, 0
    for call, ((mk, pk), (mp, pp)) in enumerate(zip(log_k, log_p)):
        diff = (mk != mp).any(-1)
        n_diff += int(diff.sum())
        per_row = diff.shape[0] // rows
        for b in range(rows):
            hit = diff[b * per_row:(b + 1) * per_row].nonzero()
            if b in first or not hit.numel():
                continue
            tok = b * per_row + int(hit[0])
            top = torch.sort(pp[tok], descending=True).values
            gap = float(top[top_k - 1] - top[top_k])
            dprob = float((pk[tok] - pp[tok]).abs().max())
            first[b] = {"call": call, "step": call // layers, "token": tok,
                        "gap": gap, "max_abs_dprob": dprob,
                        "near_tie": gap <= 2.0 * dprob}
    return first, n_diff


def moe_parity(model, params, toks, dtype_name, wrappers, plains):
    """``parity`` for the MoE path, where a routing flip at a near-tie
    moves an expert's capacity slots and so every later token of its group:
    the same prompts through the kernels and through their plain versions,
    every routing call's mask recorded.  A step within ``LOGIT_BOUND``
    passes; from a row's first differing routing decision on, a step over
    the bound, or a parting of tokens, is explained only if that decision
    was a near-tie in the plain run (gap between its k-th and (k+1)-th
    probability <= 2 max |delta prob| of the token: each of the two moves
    by at most max |delta prob|); a parting before it only by a top-2
    logit near-tie, as in ``parity``."""
    from contextlib import ExitStack
    from repro_torch.kernels import moe_routing as mr
    target = "repro_torch.models.layers.moe_routing"
    runs = {}
    for side, route in (("kernel", mr.moe_routing),
                        ("plain", mr.moe_routing_plain)):
        log = []
        counts = launch_counts(wrappers)
        with ExitStack() as stack:
            if side == "plain":
                for name, plain in plains.items():
                    stack.enter_context(mock.patch(name, plain))
            stack.enter_context(mock.patch(target,
                                           routing_recorder(route, log)))
            logits, out = traced_generate(model, params, toks)
        launched = {k: n - counts[k] for k, n in launch_counts(wrappers).items()}
        if side == "kernel" and not all(launched.values()):
            raise SystemExit(f"FAIL moe parity: the kernel run launched "
                             f"{launched}")
        if side == "plain" and any(launched.values()):
            raise SystemExit(f"FAIL moe parity: the plain run launched "
                             f"{launched}")
        runs[side] = (logits, out, log)
    (logits_k, toks_k, log_k), (logits_p, toks_p, log_p) = (runs["kernel"],
                                                           runs["plain"])
    T, B = logits_p.shape[:2]
    first, n_diff = first_routing_partings(log_k, log_p, B,
                                           model.cfg.n_layers,
                                           model.cfg.moe.top_k)
    bound = LOGIT_BOUND[dtype_name]
    equal, partings, worst, over = 0, [], 0.0, []
    for b in range(B):
        flip = first.get(b)
        for t in range(T):
            plain, delta = logits_p[t, b], logits_k[t, b] - logits_p[t, b]
            dmax = float(delta.abs().max())
            rel = dmax / float(plain.abs().max())
            worst = max(worst, rel)
            routed = (flip is not None and flip["step"] <= t
                      and flip["near_tie"])
            if rel > bound:
                over.append({"row": b, "step": t, "rel": rel,
                             "explained": routed})
            if int(toks_k[b, t]) != int(toks_p[b, t]):
                top2 = plain.topk(2).values
                gap = float(top2[0] - top2[1])
                partings.append({"row": b, "step": t, "gap": gap,
                                 "max_abs_dlogit": dmax,
                                 "explained": gap <= dmax or routed})
                break
            equal += 1
    line = {"arch": model.cfg.name, "dtype": dtype_name,
            "layers": model.cfg.n_layers, "rows": B, "steps": T,
            "routing_calls": len(log_p), "differing_routing_decisions": n_diff,
            "first_routing_parting": first, "equal_tokens": equal,
            "bound": bound, "worst_rel_delta": worst, "partings": partings,
            "over_bound": over}
    print("moe_parity " + json.dumps(line), flush=True)
    if (any(not o["explained"] for o in over)
            or any(not p["explained"] for p in partings)):
        raise SystemExit(f"FAIL moe parity {dtype_name}: a step over the "
                         "bound or a parting of tokens is not explained")
    return line


def routing_exact_parity(model, params, toks, wrappers):
    """The served path with only the router swapped for its plain version
    (the attention kernels on in both runs): the logits of every step and
    the tokens must be bit-identical."""
    import torch
    from repro_torch.kernels import moe_routing as mr
    counts = launch_counts(wrappers)
    logits_k, toks_k = traced_generate(model, params, toks)
    mid = launch_counts(wrappers)
    with mock.patch("repro_torch.models.layers.moe_routing",
                    mr.moe_routing_plain):
        logits_p, toks_p = traced_generate(model, params, toks)
    end = launch_counts(wrappers)
    line = {"arch": model.cfg.name, "dtype": model.cfg.dtype,
            "layers": model.cfg.n_layers,
            "kernel_run_launches": {k: mid[k] - counts[k] for k in mid},
            "plain_router_run_launches": {k: end[k] - mid[k] for k in end},
            "logits_equal": torch.equal(logits_k, logits_p),
            "tokens_equal": torch.equal(toks_k, toks_p),
            "max_abs_dlogit": float((logits_k - logits_p).abs().max())}
    print("routing_parity " + json.dumps(line), flush=True)
    if (not line["logits_equal"] or not line["tokens_equal"]
            or not line["kernel_run_launches"]["moe_routing"]
            or line["plain_router_run_launches"]["moe_routing"]
            or not line["plain_router_run_launches"]["flash_attention"]):
        raise SystemExit("FAIL routing parity: the router's kernel and its "
                         "plain version part on the served path")
    return line


def decode_profile(model, params, toks, share=("decode_attention_share",
                                               "decode_attention_"), steps=4):
    """Host and device time of ``steps`` decode steps after the prompt:
    host ms per step (the device synchronised at the end), device ms per
    step (all CUDA kernels in the profiler's trace), idle share, the share
    of the kernels whose names contain ``share[1]`` (reported as
    ``share[0]``) and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.kvcache import pad_cache
    from repro_torch.serving.sampling import greedy
    logits, caches = model.prefill(params, {"tokens": toks})
    caches = pad_cache(caches, model.init_cache(toks.shape[0],
                                                PROMPT + GEN + 8))
    state = {"tok": greedy(logits), "pos": toks.shape[1], "caches": caches}

    def step():
        logits, state["caches"] = model.decode(
            params, state["caches"], {"token": state["tok"][:, None],
                                      "pos": state["pos"]})
        state["tok"] = greedy(logits)
        state["pos"] += 1

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    device = sum(by_name.values())
    part = sum(v for k, v in by_name.items() if share[1] in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    line = {"arch": model.cfg.name, "steps": steps,
            "host_ms_per_step": host_ms,
            "device_ms_per_step": device if by_name else None,
            "idle_share": 1.0 - device / host_ms if by_name else None,
            share[0]: part / device if device else None,
            "kernels_per_step": sum(
                1 for e in prof.events()
                if e.device_type == DeviceType.CUDA) / steps,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}
    print("decode_profile " + json.dumps(line), flush=True)
    return line


# ---------------------------------------------------------------------------


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True)
    return proc.stdout.strip()


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: no src/repro_torch beside it; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch._device import resolve_device
    from repro_torch.core.hierarchy import HierarchicalSynergAI
    from repro_torch.core.offline import characterize
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.workers import synth_fleet
    from repro_torch.core.workload import regional_scenario, scenario
    from repro_torch.kernels import _build
    from repro_torch.kernels import scheduler_score as ss

    # 1. the card, the build (one nvcc per source, all started together)
    resolve_device()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = next((r for key, r in HBM_RATE if key in name), 3.35e12)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; HBM rate {rate / 1e12} TB/s", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {', '.join(f'{s}.cu' for s in _build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for source in _build.SOURCES:
        for line in _build.build_log.get(source, "").splitlines():
            if any(key in line for key in ("registers", "Compiling", "spill",
                                           "Function properties")):
                print("  ptxas " + line.strip())
    flash_hmma_report()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False", flush=True)

    # 2a. the scoring kernels against their plain versions
    kernels = {
        "scheduler_score": dict(
            wrapper=ss.scheduler_score, plain=ss.scheduler_score_plain,
            inputs=messy_v1_inputs, nbytes=v1_bytes,
            kernel_name="score_v1_kernel",
            replaces="src/repro/kernels/scheduler_score.py:39"),
        "scheduler_score_v2": dict(
            wrapper=ss.scheduler_score_v2,
            plain=ss.scheduler_score_v2_plain, inputs=messy_v2_inputs,
            nbytes=v2_bytes, kernel_name="score_v2_kernel",
            replaces="src/repro/kernels/scheduler_score.py:108"),
    }
    worst = {k: 0.0 for k in kernels}
    worst.update(tick_score_kernel=0.0, greedy_place_kernel=0.0)
    for J, W in SHAPES:
        for kname, k in kernels.items():
            inputs = to_card(k["inputs"](J, W, seed=J + W))
            r = hold_kernel(kname, k["wrapper"], k["plain"], inputs,
                            k["nbytes"](J, W), rate, k["kernel_name"])
            worst[kname] = max(worst[kname], r["max_abs_err"])
            print(f"hold {kname} J={J} W={W}: exact, "
                  + json.dumps({key: r[key] for key in TIMES}), flush=True)
            del inputs
        torch.cuda.empty_cache()

    # 2b. the device-resident tick against its plain version
    for J, cap, W in TICK_SHAPES:
        for use_energy in (False, True):
            inputs = messy_tick_inputs(J, cap, W, seed=J + W,
                                       deep=use_energy)
            score, walk, steps = hold_tick(inputs, use_energy, rate)
            for kname, r in (("tick_score_kernel", score),
                             ("greedy_place_kernel", walk)):
                worst[kname] = max(worst[kname], r["max_abs_err"])
                print(f"hold {kname} J={J} cap={cap} W={W} "
                      f"energy={use_energy} walk_steps={steps}: exact, "
                      + json.dumps({key: r[key] for key in TIMES}),
                      flush=True)
            del inputs
            torch.cuda.empty_cache()
        print(f"hold scheduler_tick J={J} cap={cap} W={W}: exact", flush=True)

    # 2c-2d. the attention kernels against their plain versions
    attn_worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    for dtype_name in ("bfloat16", "float32"):
        for shape in FLASH_HOLDS:
            r = hold_flash(*shape, dtype_name, rate)
            attn_worst["flash_attention"] = max(attn_worst["flash_attention"],
                                                r["max_abs_err"])
        for shape in DECODE_HOLDS:
            r = hold_decode(*shape, dtype_name, rate)
            attn_worst["decode_attention"] = max(
                attn_worst["decode_attention"], r["max_abs_err"])
        torch.cuda.empty_cache()

    # 2e. the WKV scan against its plain version
    rwkv_holds = {shape + (dtype_name,): hold_rwkv(*shape, dtype_name, rate)
                  for dtype_name in ("float32", "bfloat16")
                  for shape in RWKV_HOLDS}
    torch.cuda.empty_cache()

    # 2f. the MoE router against its plain version, bit for bit, then its
    # two designs on each side of the switch-over
    from repro_torch.kernels import moe_routing as mr
    if _build.load("moe_routing").synergai_moe_routing_switch() != \
            mr.SWITCH_T:
        raise SystemExit("FAIL moe_routing: the kernel's switch-over T is "
                         "not moe_routing.SWITCH_T")
    routing_holds = {shape + (dtype_name,): hold_routing(*shape, dtype_name,
                                                         rate)
                     for dtype_name in ("bfloat16", "float32")
                     for shape in ROUTING_HOLDS + (
                         (mr.SWITCH_T, 4096, 16, 2, "random"),)}
    for T in (4, 1024, mr.SWITCH_T - 1, mr.SWITCH_T, 1536, 4096):
        router_designs(T, 4096, 16, 2, rate)
    torch.cuda.empty_cache()

    # 3. the scheduling path at full size
    cd = characterize()
    fleet = synth_fleet(*POOLS)
    main_path = {
        "scheduler_score": main_path_run(
            "job-v1", cd, fleet, "job", None, False, ss.scheduler_score),
        "scheduler_score_v2": main_path_run(
            "batched-streaming-v2", cd, fleet, "batched", (2.0, 2.5), True,
            ss.scheduler_score_v2),
    }
    resident = {
        "job-resident": resident_run(
            "job-resident", cd, fleet,
            scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet, seed=0),
            "job", synergai),
        "batched-streaming-resident": resident_run(
            "batched-streaming-resident", cd, fleet,
            scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet, seed=0,
                     serving="batched", streaming=(2.0, 2.5)),
            "batched", lambda fn: SynergAI(score_fn=fn, energy_weight=0.5)),
    }
    regions = synth_fleet(*POOLS, regions=3)
    resident["hier-resident"] = resident_run(
        "hier-resident", cd, regions,
        regional_scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=regions, seed=0),
        "job", lambda fn: HierarchicalSynergAI(score_fn=fn))

    tick_stages(cd, fleet, scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet,
                                    seed=0)[:3000])

    # 4-6. the serving path at full width, its parity, a decode-step profile
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.models.registry import build_model
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=model.device)
                               .manual_seed(0))
    torch.cuda.synchronize()
    print(f"params: {SERVE_ARCH} {cfg.dtype}, {cfg.n_layers} layers x "
          f"d_model {cfg.d_model}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B parameters "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator(device=model.device).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (SERVE_BATCH, PROMPT),
                             generator=rng, device=model.device)
               for _ in range(REQUESTS)]
    attn = {"flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention}
    L = cfg.n_layers
    serve_launches = serve_run(
        model, params, prompts, {**attn, "moe_routing": mr.moe_routing},
        {"flash_attention": L * REQUESTS, "decode_attention": 0,
         "moe_routing": 0},
        {"flash_attention": 0, "decode_attention": L * (GEN - 1) * REQUESTS,
         "moe_routing": 0})
    attn_plains = {
        "repro_torch.models.common.flash_attention": fa.flash_attention_plain,
        "repro_torch.models.common.decode_attention":
            da.decode_attention_plain}
    parity(model, params, prompts[0], "bfloat16", attn, attn_plains)
    profile_line = decode_profile(model, params, prompts[0])
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    parity(model32, params, prompts[0], "float32", attn, attn_plains)
    del params
    torch.cuda.empty_cache()

    # 4b-6b. the RWKV serving path at full width, its parity, a decode-step
    # profile
    rcfg = get_config(RWKV_ARCH)
    rmodel = build_model(rcfg)
    t0 = time.perf_counter()
    params = rmodel.init_params(torch.Generator(device=rmodel.device)
                                .manual_seed(0))
    torch.cuda.synchronize()
    print(f"params: {RWKV_ARCH} {rcfg.dtype}, {rcfg.n_layers} layers x "
          f"d_model {rcfg.d_model}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator(device=rmodel.device).manual_seed(1)
    prompts = [torch.randint(0, rcfg.vocab, (SERVE_BATCH, PROMPT),
                             generator=rng, device=rmodel.device)
               for _ in range(REQUESTS)]
    wkv = {"rwkv_scan": rs.rwkv_scan, **attn}
    L = rcfg.n_layers
    rwkv_launches = serve_run(
        rmodel, params, prompts, {**wkv, "moe_routing": mr.moe_routing},
        {"rwkv_scan": L * REQUESTS, "flash_attention": 0,
         "decode_attention": 0, "moe_routing": 0},
        {"rwkv_scan": L * (GEN - 1) * REQUESTS, "flash_attention": 0,
         "decode_attention": 0, "moe_routing": 0})
    wkv_plains = {"repro_torch.models.layers.rwkv_scan": rs.rwkv_scan_plain}
    parity(rmodel, params, prompts[0], "bfloat16", wkv, wkv_plains)
    rwkv_profile = decode_profile(rmodel, params, prompts[0],
                                  share=("wkv_share", "rwkv_scan_kernel"))
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    parity(build_model(dataclasses.replace(rcfg, dtype="float32")), params,
           prompts[0], "float32", wkv, wkv_plains)
    del params, prompts
    torch.cuda.empty_cache()

    # 4c-6c. the MoE serving path: phi3.5-moe at full width with 24 of its
    # 32 layers, its parity (i: the router alone, bit for bit; iii: all
    # three kernels in bf16; ii: all three in f32 on the first 4 layers), a
    # decode-step profile
    mcfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    mmodel = build_model(mcfg)
    t0 = time.perf_counter()
    params = mmodel.init_params(torch.Generator(device=mmodel.device)
                                .manual_seed(0))
    torch.cuda.synchronize()
    print(f"params: {MOE_ARCH} {mcfg.dtype}, {mcfg.n_layers} of "
          f"{get_config(MOE_ARCH).n_layers} layers x d_model {mcfg.d_model}, "
          f"{mcfg.moe.n_experts} experts top-{mcfg.moe.top_k}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s; depth cut to "
          f"{MOE_LAYERS}: all 32 layers are 83.7 GB in bf16, more than the "
          "card's 80 GB, and 24 leave ~15 GB for the cache and activations",
          flush=True)
    rng = torch.Generator(device=mmodel.device).manual_seed(1)
    prompts = [torch.randint(0, mcfg.vocab, (SERVE_BATCH, PROMPT),
                             generator=rng, device=mmodel.device)
               for _ in range(REQUESTS)]
    moe_w = {"moe_routing": mr.moe_routing, **attn}
    L = mcfg.n_layers
    moe_launches = serve_run(
        mmodel, params, prompts, {**moe_w, "rwkv_scan": rs.rwkv_scan},
        {"moe_routing": L * REQUESTS, "flash_attention": L * REQUESTS,
         "decode_attention": 0, "rwkv_scan": 0},
        {"moe_routing": L * (GEN - 1) * REQUESTS, "flash_attention": 0,
         "decode_attention": L * (GEN - 1) * REQUESTS, "rwkv_scan": 0})
    routing_exact_parity(mmodel, params, prompts[0], moe_w)
    moe_parity(mmodel, params, prompts[0], "bfloat16", moe_w, attn_plains)
    moe_profile = decode_profile(mmodel, params, prompts[0],
                                 share=("moe_routing_share",
                                        "moe_routing_kernel"))
    # the f32 parity on the first layers: cloned in bf16, the served params
    # freed, and only then cast, so the card never holds both
    if len(params["groups"]) != 1:
        raise SystemExit(f"FAIL {MOE_ARCH}: {len(params['groups'])} layer "
                         "groups, expected 1")
    first = {"embed": tree_map(lambda t: t.clone(), params["embed"]),
             "groups": [tree_map(lambda t: t[:MOE_F32_LAYERS].clone(),
                                 params["groups"][0])]}
    del params
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.float(), first)
    del first
    torch.cuda.empty_cache()
    moe_parity(build_model(dataclasses.replace(
        mcfg, n_layers=MOE_F32_LAYERS, dtype="float32")), params, prompts[0],
        "float32", moe_w, attn_plains)
    del params, prompts
    torch.cuda.empty_cache()

    # 7. the launch floor, the kernels at their paths' mean shapes, and the
    # result
    print("launch floor: " + json.dumps(
        {"device_ms": launch_floor_ms(),
         "op": "torch.add of two one-element float32 tensors"}), flush=True)
    W = len(fleet)
    rows = []
    for kname, k in kernels.items():
        launches, mean_rows = main_path[kname]
        J = max(1, round(mean_rows))
        inputs = to_card(k["inputs"](J, W, seed=J))
        r = hold_kernel(kname, k["wrapper"], k["plain"], inputs,
                        k["nbytes"](J, W), rate, k["kernel_name"])
        print(f"hold {kname} at the main path's mean shape J={J} W={W}: "
              "exact, " + json.dumps({key: r[key] for key in TIMES}),
              flush=True)
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scheduler_score.cu",
            "replaces": k["replaces"], "launches": launches,
            "max_abs_err": max(worst[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": r["device_ms"],
            "shape": [J, W]})
    # the tick kernels: launches summed over the three resident runs, held
    # at the job-resident run's mean queue length and pool rows
    _, mean_j, mean_cap = resident["job-resident"]
    J, cap = max(1, round(mean_j)), max(1, round(mean_cap))
    inputs = messy_tick_inputs(J, cap, W, seed=J)
    score, walk, steps = hold_tick(inputs, False, rate)
    for kname, r, replaces in (
            ("tick_score_kernel", score,
             "src/repro/kernels/scheduler_score.py:215"),
            ("greedy_place_kernel", walk,
             "src/repro/kernels/scheduler_score.py:344")):
        print(f"hold {kname} at the main path's mean shape J={J} cap={cap} "
              f"W={W} walk_steps={steps}: exact, "
              + json.dumps({key: r[key] for key in TIMES}), flush=True)
        rows.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scheduler_tick.cu",
            "replaces": replaces,
            "launches": sum(run[0][kname] for run in resident.values()),
            "max_abs_err": max(worst[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": r["device_ms"],
            "shape": [J, cap, W]})
    # the attention kernels at the serving path's shapes in bf16: flash at
    # the prompt, decode at the mean k_valid of the 31 decode steps
    flash = hold_flash(SERVE_BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, None, "bfloat16", rate)
    mean_valid = PROMPT + 1 + (GEN - 2) // 2
    decode = hold_decode(SERVE_BATCH, PROMPT + GEN + 8, cfg.n_heads,
                         cfg.n_kv_heads, cfg.head_dim, mean_valid,
                         "bfloat16", rate,
                         label=" at the serving path's mean shape")
    for kname, r, line, shape in (
            ("flash_attention", flash, 26,
             [SERVE_BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]),
            ("decode_attention", decode, 24,
             [SERVE_BATCH, PROMPT + GEN + 8, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, mean_valid])):
        # both attention serving paths: qwen3-4b and phi3.5-moe
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": f"src/repro/kernels/{kname}.py:{line}",
            "launches": serve_launches[kname] + moe_launches[kname],
            "max_abs_err": max(attn_worst[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "shape": shape, "dtype": "bfloat16"})
    # the WKV scan at the RWKV serving path's shapes (its inputs are f32 in
    # the model whatever the params' dtype), from 2e: the prefill and, under
    # "decode_step", one decode step on the cache's state
    hd = rcfg.ssm.rwkv_head_dim
    pre_shape = (SERVE_BATCH, PROMPT, rcfg.d_model // hd, hd, False)
    dec_shape = (SERVE_BATCH, 1, rcfg.d_model // hd, hd, True)
    pre = rwkv_holds[pre_shape + ("float32",)]
    dec = rwkv_holds[dec_shape + ("float32",)]
    rows.append({
        "name": "rwkv_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
        "replaces": "src/repro/kernels/rwkv_scan.py:22",
        "launches": rwkv_launches["rwkv_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in rwkv_holds.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None, "device_ms": pre["device_ms"],
        "shape": list(pre_shape[:4]), "dtype": "float32",
        "decode_step": dict({k: dec[k] for k in TIMES + ("bound_by",)},
                            shape=list(dec_shape[:4]))})
    # the router at the MoE serving path's shapes (x in bf16, the model's),
    # from 2f: the prefill and, under "decode_step", one decode step
    n_exp, top_k = mcfg.moe.n_experts, mcfg.moe.top_k
    pre_shape = (SERVE_BATCH * PROMPT, mcfg.d_model, n_exp, top_k, "random")
    dec_shape = (SERVE_BATCH, mcfg.d_model, n_exp, top_k, "random")
    pre = routing_holds[pre_shape + ("bfloat16",)]
    dec = routing_holds[dec_shape + ("bfloat16",)]
    rows.append({
        "name": "moe_routing", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_routing.cu",
        "replaces": "src/repro/kernels/moe_routing.py:21",
        "launches": moe_launches["moe_routing"],
        "max_abs_err": max(r["max_abs_err"] for r in routing_holds.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None, "three_call_ms": pre["three_call_ms"],
        "device_ms": pre["device_ms"], "shape": list(pre_shape[:4]),
        "dtype": "bfloat16",
        "decode_step": dict({k: dec[k] for k in TIMES + ("bound_by",)},
                            shape=list(dec_shape[:4]))})
    for line, key in ((profile_line, "decode_attention_share"),
                      (rwkv_profile, "wkv_share"),
                      (moe_profile, "moe_routing_share")):
        print(f"decode step {line['arch']}: " + json.dumps(
            {k: line[k] for k in ("host_ms_per_step", "device_ms_per_step",
                                  "idle_share", key)}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
