#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA H100 and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, the PyTorch version; build every CUDA
   source in ``src/repro_torch/kernels/csrc`` in parallel (one ``nvcc``
   each), time the build and print ``ptxas``'s register and spill lines
   (every flash instantiation's among them, forward and backward) and each
   flash kernel's tensor-core (``HMMA``) instructions from ``cuobjdump``'s
   SASS (the bf16 kernels, ``_mma``, must have them, the f32 ones none);
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
       hd 80, window 256), a gemma-like MQA shape (hd 256, K = 1), hymba's
       prefill [4, 1024, 25, 5, 64] (G = 5) windowed at 1,024 and
       seamless-m4t's encoder and cross prefill [4, 1024, 16, 16, 64]
       non-causal, the profiler showing the tensor-core kernel for bf16 and
       the FMA kernel for f32, and
   (d) ``decode_attention`` on the serving buffer [4, 1064, 32, 8, 128] at
       k_valid 1, 1024 (the end of a split of ``plan_splits``), 1025 and
       1064, a ragged hd-80 buffer, an hd-256 MQA buffer and G = 5
       (25 query over 5 kv heads: a ragged buffer, hymba's full 1,024-slot
       ring and its global layers' buffer just after the prompt); both in
       f32 (within 2e-5, TF32 off) and
       bf16 (within one bf16 ulp, 2**-7 relative), each beside SDPA as the
       library yardstick; three calls in a row bit-identical (the merge of
       the splits runs in split order) with the ticket counters back at 0,
       and the profiler showing one ``decode_attention_*`` kernel a call;
       its log-sum-exp instances (``DECODE_LSE_HOLDS``: every key masked
       at k_valid 0, k_valid on a split boundary, G = 5) with the f32
       output rounded bit-equal to the output without lse and the lse
       within ``DECODE_LSE_TOL`` of ``torch.logsumexp``, both instances
       timed; and two streams running ``STREAM_CALLS`` calls each at once,
       every output bit-equal to the call alone, the tickets (one buffer a
       stream) back at 0, with the launches that overlapped one on the
       other stream counted from the profiler's trace, and a control with
       one buffer forced on both streams reported;
   (e) ``rwkv_scan`` at [B, S, H, hd] = [4, 1024, 32, 64] from a zero state
       (the RWKV serving prefill), [4, 1, 32, 64] from a random state (a
       decode step), [2, 1000, 8, 64] and [1, 515, 2, 64] from a random
       state (ragged lengths, few heads: four CTAs a head) and an hd-16
       shape, in f32 and bf16 inputs: y and the end state bit-equal to
       ``rwkv_scan_plain`` (the serving path's parity rests on it), the
       update in place (``state_out=state``) equal to the one out of place,
       the chunk states a training forward writes (``ckpt``, the state
       before every 64th step) bit-equal to the plain version's, with y and
       the end state those without them;
       ``rwkv_scan.LANES`` and ``COLS`` are the kernel's own;
       no PyTorch call computes the recurrence, so no library yardstick;
   (f) ``moe_routing`` at [T, D, E, k] = [4096, 4096, 16, 2] (the phi3.5
       prefill), [4, 4096, 16, 2] (a decode step), [1, 4096, 16, 2],
       [SWITCH_T, 4096, 16, 2] (the first T of the prefill design),
       [1000, 4000, 16, 2], [4096, 5120, 160, 6] and [4, 5120, 160, 6]
       (the deepseek-v2 prefill and decode step), an
       underflowing probability and tied experts, x in bf16 and f32, gates
       and mask bit-equal; no one PyTorch call routes, so the three-call
       sequence (matmul, softmax, topk + scatter) is timed as context; then
       both of the kernel's designs (decode and prefill) at T on each side
       of the switch-over, each bit-equal, with their device times;
   (h) the flash backward (``flash_attention_bwd``, three kernels a call)
       against ``flash_attention_bwd_plain`` at qwen3-4b's training shape
       [2, 4096, 32, 8, 128] causal, the serving shape, seamless-m4t's
       [4, 1024, 16, 16, 64] non-causal, the ragged hd-80 shape windowed at
       256, gemma-like MQA at hd 256, hymba's G = 5 windowed at 1,024 and
       its training shapes [2, 4096, 25, 5, 64] windowed at 1,024 and
       global, in f32 (TF32 off) and bf16: dq, dk and dv within ``BWD_REL`` of
       each one's max |plain|, two calls bit-identical, the profiler's
       kernels of a call exactly its three (in bf16 the D pre-pass and the
       tensor-core ``_mma`` dK/dV and dQ kernels, in f32 the FMA ones, by
       their names), the forward's ``lse`` against
       ``torch.logsumexp`` of the masked scores (``LSE_TOL``); the kernel's,
       the plain version's and the backward of SDPA (``enable_gqa``, timed
       alone) milliseconds, the bound by operations (10 hd flops a visible
       pair);
   (i) the router backward (``moe_routing_bwd``, three kernels a call where
       T > ``DW_CHUNK``, else two, held in the profiler) against
       ``moe_routing_bwd_plain`` at phi3.5-moe's
       training shape [T, D, E, k] = [8192, 4096, 16, 2], deepseek-v2's
       [2048, 5120, 160, 6], a ragged [1000, 4000, 16, 2], a decode step's
       [4, 4096, 16, 2], an underflowing probability and tied experts, x in
       bf16 and f32: dx and dW bit-equal (the same roundings in the same
       order), two calls bit-identical; the kernel's, its kernels' and the
       plain version's milliseconds and the bound (3 x 2 T D E f32
       operations, or the bytes); no one PyTorch call computes it;
   (j) the WKV backward (``rwkv_scan_bwd``, one kernel a call, a
       thread-block cluster of ``rwkv_scan.bwd_split`` CTAs a head) against
       ``rwkv_scan_bwd_plain`` at rwkv6's training shape [B, S, H, hd] =
       [2, 4096, 32, 64] from zeros, a ragged last chunk [2, 1000, 8, 64],
       [2, 333, 8, 16], [1, 515, 2, 64] from a random state with a nonzero
       end-state cotangent, exactly one chunk [1, 64, 2, 32], one step
       [2, 1, 4, 64] (from a state) and three shapes that reach the other
       splits: dr, dk, dv, dw and d state_0 bit-equal (the same roundings
       in the same order) at every split the wrapper can pick, two calls
       bit-identical, one ``rwkv_scan_bwd_kernel`` a call in the profiler;
       the kernel's and the plain version's milliseconds and the bound
       (``RWKV_BWD_OPS`` hd^2 f32 operations a step and head, or the
       bytes); no PyTorch call computes it; ``rwkv_scan.CHUNK`` is both
       kernels' own, and ``BWD_STEPS``, ``BWD_LAYOUT`` and the splits are
       the backward kernel's;
3. the scheduling path at full size, on the 10,000-job MMPP scenario over
   the 64-pool fleet ``synth_fleet(8, 28, 28)``: (a) job mode through v1,
   (b) batched with streaming deadlines through v2, and the device-resident
   tick (c) in job mode, (d) batched with streaming deadlines and
   ``energy_weight=0.5``, (e) under ``HierarchicalSynergAI`` over three
   regions of the same fleet on ``regional_scenario``.  Each run counts its
   kernel launches (the counts set to 0 just before it), must give the same
   ``JobResult``s as the same run on the CPU, and is set beside the default
   numpy ``SynergAI()``; every run's CPU and numpy runs (and 3g's host
   policies and the paper experiments' runs off the card) are made in
   forked children, all forked at the phase's start and run
   ``os.cpu_count() - 2`` at a time in the card runs' order
   (``Children``), so that they run beside the card runs; the resident
   runs also print their per-tick transfer counters (held equal to the
   CPU run's, ``profile_reclaims`` among them) and their edge energy (held
   equal too); (d) prints its
   ``normalized_edge_energy`` and ``offload_fraction``, card against numpy;
   one more job-mode resident run over the first 3,000 jobs times the
   stages of a device tick;
3f. drift: the 10,000-job ``drift`` scenario on the same 64 pools over
   three regions, 20 edge pools slowed ~5x from a third of the way in
   (``synth_degradations``), in five runs: resident ``SynergAI`` (i) stale,
   (ii) with an ``OnlineRecharacterizer`` and (iii) with the oracle (the
   true factors at t = 0), (iv) v2 online and (v) resident
   ``HierarchicalSynergAI`` online (one re-characterizer for all regions).
   Each run is held as in 3, with a fresh re-characterizer for each of its
   card, CPU and numpy runs; an online run must refresh at least once and
   reclaim rows on the card, and its refreshes and final overlay scales
   must equal the CPU run's bit for bit; online must violate less than
   stale.  One ``drift`` line a run;
3g. the paper's comparison policies, which run on the host: SLO-MAEL and
   the five baselines (RR, SRR, LRU, MRU, BE) on the jobs of (c), beside
   (c)'s SynergAI; then the paper's experiments (``make_experiment`` DL-FL,
   DL-FH, DH-FH, seeds 1-5) with all seven policies, SynergAI on the
   resident backend (held to its CPU run, its launches to its ticks); both
   print the ratios of ``examples/scheduler_comparison.py``;
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
4d. the MLA family: deepseek-v2-236b at full width (MLA ranks 1,536 / 512,
   160 routed + 2 shared experts, top-6) with its depth cut from 60 to 7
   layers (all 60 do not fit the card) in bf16, the same 4 requests on the
   engine's default, paper-faithful path (``absorb_mla=False``); the
   routing launches are counted from 0 and must be 7 x 4 in prefill and
   7 x 31 x 4 in decode, with no attention or WKV launch (MLA's shapes
   take the XLA-path attention); its parity (i) with the router on its
   plain version, logits and tokens bit-identical, (ii) in f32 on the first
   2 layers and (iii) in bf16 on all 7, as 4c's; the absorbed decode
   (``absorb_mla=True``) held to the logit bounds, bf16 on all 7 layers
   and f32 on the first 2, against the expanded decode at the absorbed
   mode's score scale (the two modes divide the scores by different
   widths, so they differ at their own scales; that difference is
   printed); decode-step profiles of both modes;
4e. the VLM family: llama-3.2-vision-11b at full width, all 40 layers (32
   self-attention, 8 gated cross-attention layers at 3, 8, ..., 38), the
   cross layers' gates set to 0.5 (the init's 0 would zero their path),
   ``vision_embeds`` [4, 1,601, 4,096] of 0.02 x a standard normal, the
   same 4 requests; the attention launches are counted from 0 and must be
   32 x 4 flash in prefill and 32 x 31 x 4 decode in decode (the cross
   layers' shapes take the XLA-path attention), no routing or WKV launch;
   its parity in bf16 on all 40 layers and in f32 on the first 10 (two
   cross layers among them), and its decode-step profile;
4f. the hybrid family: hymba-1.5b at full width, all 32 layers (attention
   beside a Mamba branch in each; 3 global layers, 29 windowed at 1,024
   with a 1,024-slot ring), the same 4 requests; the attention launches
   are counted from 0 and must be 32 x 4 flash in prefill and 32 x 31 x 4
   decode in decode, no routing or WKV launch (the Mamba scan is PyTorch,
   as it is ``lax.scan`` in the JAX package); its parity in bf16 and in
   f32 on all 32 layers (bf16 within the plain bf16 run's own distance
   from the f32 run where that is above 3e-2: this random-weight model's
   bf16 noise is), its decode-step profile and a prefill's profile with
   the Mamba recurrence's share of the device time;
4g. the encoder-decoder family: seamless-m4t-medium at full width, 12
   encoder and 12 decoder layers, ``audio_embeds`` [4, 1,024, 1,024] of
   0.02 x a standard normal, the same 4 requests; the prefill must launch
   flash 36 x 4 times, 24 x 4 non-causal (the encoder's and the cross
   layers') and 12 x 4 causal (the self layers'), and decode must launch
   decode attention 12 x 31 x 4 times (the cross layers' decode takes the
   XLA-path attention), no routing or WKV launch; its parity in bf16 and
   f32 at full depth and its decode-step profile;
5a. training: qwen3-4b at full width and depth in bf16 (4.411 B, remat on),
   3 AdamW steps (the launcher's schedule rule) through ``make_train_step``
   on batches of 2 x 4,096 tokens from the ``DataLoader`` copy (seed 0);
   each step's launches counted from 0 and held to 72 flash forwards (36
   and their remat recomputation) and 36 backward calls, no decode, WKV
   or routing launch; step seconds, tokens/s, peak memory; a fourth step
   profiled (device ms by kind of kernel, the optimizer's, the loss chunks'
   alone, idle share); holds (i) step 0's loss against the plain
   attention's, relative 1e-2, (ii) one f32 step (TF32 off) of the model
   cut to 4 layers on the kernels against the plain versions
   (``held_f32_step``: loss, every leaf's grad, m, v; the params through
   Adam's first step), (iii) resume equivalence at the reduced size, bit
   for bit (``resume_check``);
5b. training: seamless-m4t-medium at full width and depth (12 + 12
   layers, 0.978 B), batch 4 x 1,024 with ``audio_embeds`` [4, 1,024,
   1,024] from the launcher's stub, 3 steps; each step 72 flash forwards,
   48 of them non-causal (the encoder's and the cross layers'), and 36
   backward calls, 24 non-causal; holds (i) and (ii) at full depth;
5c. training the MoE family: phi3.5-moe-42b-a6.6b at full width with 4 of
   its 32 layers (65.6 GB of train state; 5 would not fit the card), batch
   2 x 4,096, 3 steps; each step 8 router forwards (4 and their remat
   recomputation), 4 router backward calls, 8 flash forwards and 4 flash
   backward calls, no decode or WKV launch; holds (i) step 0's loss against
   the plain versions' (router and attention), (ii) one f32 step on 1 layer
   on the kernels against the plain versions, (iii) resume equivalence at
   the reduced size; the reckoned train state beside the measured peak;
5d. training MLA: deepseek-v2-236b at full width with 1 of its 60 layers
   (5.02 B parameters, 60.3 GB of train state), batch 1 x 2,048, 3 steps;
   each step 2 router forwards and 1 router backward, no flash launch (MLA
   takes the XLA-path attention); holds (i) and, in place of (ii), whose
   f32 optimizer state would not fit, the f32 loss and every grad on the
   kernels against the plain versions on that layer;
5e. training the hybrid family: hymba-1.5b at full width and depth (32
   layers, 3 global and 29 windowed at 1,024, the Mamba recurrence under
   ``chunked_time_scan``), batch 2 x 4,096 (``train_4k``'s length, so the
   window binds), 3 steps; each step 64 flash forwards and 32 backward
   calls, no other kernel; holds (i), (ii) on its first 4 layers (global
   layer 0 and three windowed); the fourth step profiled on the first 4
   layers (a full-depth step is ~10^6 launches, too many to trace), with
   the Mamba recurrence's (``addcmul``) share of its device time;
5f. training the VLM family: llama-3.2-vision-11b at full width with 20 of
   its 40 layers (16 self-attention, 4 gated cross-attention layers; the
   deepest multiple of 5 whose reckoned train state, 12 bytes a
   parameter, leaves 15 GB of the 80 for activations), every cross
   layer's gates set to 0.5, ``vision_embeds`` [2, 1,601, 4,096] from the
   launcher's stub, batch 2 x 4,096, 3 steps; each step 2 flash forwards
   and 1 backward call a self layer, none for the cross layers (their
   shapes take the XLA-path attention); holds (i) and (ii) on its first 5
   layers (one cross layer);
5g. training the RWKV family: rwkv6-1.6b at full width and depth (24
   layers, 1.609 B parameters), batch 2 x 4,096, 3 steps; each step 48 WKV
   forwards (24 and their remat recomputation, each writing its chunk
   states) and 24 WKV backward calls, no flash, decode or router launch;
   holds (i) and (ii) on its first 2 layers; the fourth step profiled at
   full depth, with the WKV forward's and backward's device time;
5h. the one-device mesh: a world-size-1 ``nccl`` group on a ``FileStore``
   and the (1, 1) ``data x model`` mesh on the card, the active mesh while
   the DTensor runs go on; qwen3-4b on 4 layers (2 steps), phi3.5-moe on 1
   (1 step) and rwkv6-1.6b on 2 (1 step) trained at full width, bf16, 2 x
   4,096, once on plain tensors and once on DTensors (params by
   ``TRAIN_RULES``, m and v by ``opt_pspecs``, the batch by
   ``batch_pspecs``, ``grad_shardings`` from ``opt_pspecs``): each step's
   loss and grad norm and every param, m and v leaf after them bit-equal,
   each kernel's launches equal; qwen3-4b on the same 4 layers served (4
   requests of batch 4 x 1,024 and 8 decode steps) on plain tensors, on
   DTensors (params by ``PARAM_RULES``, caches by ``cache_pspecs``) and
   again with ``ONEHOT_CACHE_UPDATE`` and with ``SHARDED_DECODE_ATTN`` (the
   sharded flash-decode on the one shard, its merge over the one-rank
   ``model`` group): every step's logits bit-equal, the flash and
   decode-attention launches equal, every decode step of every layer
   merged and a profiled step's decode kernels all the lse instance; the
   seconds a step and the host's seconds of each run;
5i. the dry run (``python -m repro_torch.launch.dryrun``, a subprocess) of
   h2o-danube-1.8b ``decode_32k`` on both production meshes (256 and 512
   fake ranks, meta tensors, no card), without and with ``--opt``: every
   record ``ok``, the matmul FLOPs plus the decode kernel's equal to the
   JAX package's count (``DRYRUN_FLOPS``);
7. the card's floor for one launch (the profiler's device time of a
   one-element ``torch.add``), the kernels at their paths' mean shapes, one
   JSON line with each kernel's launches and times, then the card's line
   from ``nvidia-smi``, then the result.

Each phase prints its seconds on a line of its own (``phase ...``).  It
needs a CUDA card and a checkout (``src/repro_torch`` beside it), and
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPES = ((2048, 256), (2043, 256), (10000, 64), (16384, 2048))
TICK_SHAPES = ((22, 506, 64), (2043, 4096, 256), (10000, 16384, 64),
               (16384, 32768, 2048))
N_JOBS = 10_000
POOLS = (8, 28, 28)
# the drift cell: a third of the edge pools slowed ~5x from a third of the
# way in (synth_degradations), on the 64-pool fleet over three regions
DRIFT = dict(factor=5.0, fraction=0.35, prefix="edge", seed=0)
# the paper's experiments (make_experiment, 24 jobs each) and seeds
EXPERIMENTS = (("DL-FL", "DL", "FL"), ("DL-FH", "DL", "FH"),
               ("DH-FH", "DH", "FH"))
EXPERIMENT_SEEDS = (1, 2, 3, 4, 5)
BASELINES = ("RR", "SRR", "LRU", "MRU", "BE")
REPS = 25                 # timed samples per kernel (median reported)
BATCH = 10                # launches per timed sample
# a plain version's call above this many seconds is timed by the hold's
# own call (the greedy walk's and the WKV backward's Python loops)
SLOW_S = 0.1
TIMES = ("ms", "device_ms", "plain_ms", "bound_ms")

# the attention kernels (B, S, H, K, hd, window, causal): the serving
# shape, a ragged danube-like shape, a gemma-like MQA shape, hymba's prefill
# (G = 5, windowed at 1,024) and seamless-m4t's encoder and cross prefill
# (non-causal)
FLASH_HOLDS = ((4, 1024, 32, 8, 128, None, True),
               (4, 1000, 32, 8, 80, 256, True),
               (2, 2048, 8, 1, 256, None, True),
               (4, 1024, 25, 5, 64, 1024, True),
               (4, 1024, 16, 16, 64, None, False))
# (B, S, H, K, hd, k_valid): the serving buffer (prompt 1,024 + 32 + 8)
# cold, just after the prompt and full; a ragged hd-80 buffer; hd-256 MQA;
# G = 5: a ragged buffer, hymba's full ring and its global layers' buffer
# just after the prompt; last, the serving buffer with k_valid at the end
# of a split (1,024)
DECODE_HOLDS = ((4, 1064, 32, 8, 128, 1), (4, 1064, 32, 8, 128, 1025),
                (4, 1064, 32, 8, 128, 1064), (4, 1000, 32, 8, 80, 777),
                (2, 2056, 8, 1, 256, 2050), (2, 1000, 25, 5, 64, 999),
                (4, 1024, 25, 5, 64, 1024), (4, 1064, 25, 5, 64, 1025),
                (4, 1064, 32, 8, 128, 1024))
DECODE_REPEATS = 3        # calls that must agree bit for bit
# the decode kernel's log-sum-exp instances (B, S, H, K, hd, k_valid): every
# key masked, a k_valid on a split boundary, G = 5 at one split short of S
DECODE_LSE_HOLDS = ((4, 1064, 32, 8, 128, 0), (4, 1064, 32, 8, 128, 1024),
                    (2, 1000, 25, 5, 64, 999))
DECODE_LSE_TOL = 1e-5     # absolute, against torch.logsumexp
STREAM_CALLS = 8          # calls on each of two streams at once
# both streams wait behind a spin of this many clock cycles (~10 ms) while
# every call is queued, so that their kernels meet on the card
STREAM_HOLD_CYCLES = 20_000_000
# the flash backward (B, S, H, K, hd, window, causal): qwen3-4b's training
# shape (the JAX package's train_4k length, batch cut to 2), the serving
# shape, seamless-m4t's encoder and cross shape (non-causal) and its
# decoder's self-attention (causal), a ragged hd-80 shape windowed at 256,
# gemma-like MQA at hd 256, hymba's G = 5 windowed, and hymba's training
# shapes (2 x 4,096), windowed and global
FLASH_BWD_HOLDS = ((2, 4096, 32, 8, 128, None, True),
                   (4, 1024, 32, 8, 128, None, True),
                   (4, 1024, 16, 16, 64, None, False),
                   (4, 1024, 16, 16, 64, None, True),
                   (4, 1000, 32, 8, 80, 256, True),
                   (2, 2048, 8, 1, 256, None, True),
                   (4, 1024, 25, 5, 64, 1024, True),
                   (2, 4096, 25, 5, 64, 1024, True),
                   (2, 4096, 25, 5, 64, None, True))
# dq, dk, dv of the backward kernel against its plain version, per tensor:
# max |delta| <= BWD_REL * max |plain|.  f32: the same f32 math summed in
# another order (the serving logit bound, 1e-4); bf16: both round their f32
# result once, so at most one bf16 ulp of the largest element, 2**-7
BWD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the forward's lse against logsumexp of the masked scores (rtol, atol): f32
# sums of exact products (bf16) or f32 FMAs in another order
LSE_TOL = (2e-5, 2e-5)
BWD_KERNELS = ("flash_attention_bwd_dot_kernel",
               "flash_attention_bwd_dkdv_kernel",
               "flash_attention_bwd_dq_kernel")
# the backward's tensor-core kernels, which bf16 launches (f32: the FMA
# kernels of the same names without the suffix)
BWD_MMA = ("flash_attention_bwd_dkdv_kernel_mma",
           "flash_attention_bwd_dq_kernel_mma")
# (rtol, atol) of a kernel against its plain version: the same f32 math
# summed in another order; in bf16 both round their f32 result once
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 1e-5)}
# dense peak by input dtype, FLOP/s (NVIDIA's H100 SXM data sheet): bf16
# on the tensor cores; f32 outside them (TF32 would change the numbers)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SERVE_ARCH, REQUESTS, SERVE_BATCH, PROMPT, GEN = "qwen3-4b", 4, 4, 1024, 32
RWKV_ARCH = "rwkv6-1.6b"
# the WKV scan (B, S, H, hd, start state): the RWKV serving prefill (zeros),
# one decode step, a ragged length, the tests' reduced head dim, two heads
# (the kernel's column split: four CTAs a head)
RWKV_HOLDS = ((4, 1024, 32, 64, False), (4, 1, 32, 64, True),
              (2, 1000, 8, 64, True), (2, 333, 8, 16, True),
              (1, 515, 2, 64, True))
# the scan against its plain version: bit-equal (the same roundings in the
# same order); max |delta| <= RWKV_REL * max |plain| is reported beside it
RWKV_REL = 1e-5
# the WKV backward (B, S, H, hd, from a random state with a nonzero
# end-state cotangent): rwkv6's training shape from zeros, a ragged last
# chunk, the tests' reduced head dim, a random state over few heads,
# exactly one chunk, one step, and shapes that reach the kernel's other
# column splits (hd 64 over 4 CTAs, hd 32 over 1 and 2); held bit for bit.
# Main checks that every split the wrapper can pick is among them
RWKV_BWD_HOLDS = ((2, 4096, 32, 64, False), (2, 1000, 8, 64, False),
                  (2, 333, 8, 16, False), (1, 515, 2, 64, True),
                  (1, 64, 2, 32, False), (2, 1, 4, 64, True),
                  (1, 256, 32, 64, True), (2, 130, 64, 32, False),
                  (1, 100, 64, 32, True))
# the backward's operations a step and (batch, head): the recomputed state
# (3 hd^2), four products (4), the G update (3) and four sums (~4)
RWKV_BWD_OPS = 14
# parity: max |logit delta| / max |plain logit| per row and step
LOGIT_BOUND = {"float32": 1e-4, "bfloat16": 3e-2}
# the MoE serving cell: phi3.5-moe at full width, its depth cut from 32 to
# 24 layers (all 32 are 83.7 GB in bf16, more than the card's 80 GB; 24 are
# 62.9 GB), and 4 of them, in f32, for the f32 parity (21.9 GB)
MOE_ARCH, MOE_LAYERS, MOE_F32_LAYERS = "phi3.5-moe-42b-a6.6b", 24, 4
# the MLA serving cell: deepseek-v2 at full width, its depth cut from 60 to
# 7 layers (one layer holds 3.971 B parameters, 7.94 GB in bf16; 7 and the
# embeddings are 57.7 GB, and 8 would leave too little for the prefill's
# naive attention, a [4, 128, 1024, 1024] f32 score tensor of 2.1 GB and
# its softmax), and 2 of them, in f32, for the f32 parity
MLA_ARCH, MLA_LAYERS, MLA_F32_LAYERS = "deepseek-v2-236b", 7, 2
# the VLM serving cell: llama-3.2-vision at full width, all 40 layers, every
# cross layer's gates set to VLM_GATE, and its first 10 layers (two cross
# layers among them), in f32, for the f32 parity
VLM_ARCH, VLM_GATE, VLM_F32_LAYERS = "llama-3.2-vision-11b", 0.5, 10
# the hybrid and encoder-decoder serving cells, nothing cut (f32 parity on
# every layer too)
HYMBA_ARCH, ENCDEC_ARCH = "hymba-1.5b", "seamless-m4t-medium"
# the training cells: qwen3-4b at full width and depth, batch 2 x 4,096
# (the JAX package's train_4k length, its batch cut to one card), its f32
# step held on its first 4 layers; seamless-m4t-medium at full width and
# depth, batch 4 x 1,024 with audio of the same length, its f32 step held
# at full depth; 3 AdamW steps each with the launcher's schedule rule
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_F32_LAYERS = "qwen3-4b", 2, 4096, 4
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 4, 1024
TRAIN_STEPS, TRAIN_LR = 3, 1e-3
# (i) step 0's loss on the kernels against the plain attention's, bf16.
# A random model's loss is about ln V whatever attention returns, so this
# catches only a NaN or gross breakage; the bf16 kernels of a step are held
# by phase 2h (the forward with its lse and the backward, at the training
# shapes) and the f32 step by (ii)
TRAIN_LOSS_REL = 1e-2
# (ii) one f32 step on the kernels against the plain versions: the loss
# (relative), each leaf's grad and m (max |delta| / max |plain|); v is
# quadratic in the grad, so a grad held at 1e-4 moves it up to 2e-4
TRAIN_F32_REL = {"loss": 1e-5, "grad": 1e-4, "m": 1e-4, "v": 2e-4}
# the free card memory, in multiples of the kernels' f32 run, under which
# that run waits on the host for the plain run (whose state and
# activations need about 1.5 more)
F32_ROOM = 2.5
# the router (T, D, E, top_k, case): the phi3.5 prefill (4 x 1,024 tokens),
# one decode step, one token, a ragged shape, the deepseek-v2 prefill and
# decode step, a probability that underflows (one logit leads by > 110) and
# tied experts (duplicated router columns); held bit for bit (main adds the
# switch-over)
ROUTING_HOLDS = ((4096, 4096, 16, 2, "random"), (4, 4096, 16, 2, "random"),
                 (1, 4096, 16, 2, "random"),
                 (1000, 4000, 16, 2, "random"), (4096, 5120, 160, 6, "random"),
                 (4, 5120, 160, 6, "random"),
                 (512, 4096, 16, 2, "underflow"), (512, 4096, 16, 2, "tie"))
# the router backward (T, D, E, top_k, case): phi3.5-moe's training T (2 x
# 4,096 tokens) and deepseek-v2's (1 x 2,048), a ragged shape, a decode
# step's T, the underflow and the tie case; held bit for bit (kernel and
# plain version do the same roundings in the same order)
ROUTING_BWD_HOLDS = ((8192, 4096, 16, 2, "random"),
                     (2048, 5120, 160, 6, "random"),
                     (1000, 4000, 16, 2, "random"), (4, 4096, 16, 2, "random"),
                     (512, 4096, 16, 2, "underflow"),
                     (512, 4096, 16, 2, "tie"))
# the MoE training cells: phi3.5-moe at full width with 4 of its 32 layers
# (one layer holds 1.300 B parameters and the untied embeddings 0.263 B; at
# 12 bytes a parameter, bf16 param and grad and f32 m and v, 4 layers are
# 65.6 GB of train state and 5 would be 81.2 GB), batch 2 x 4,096 (5a's),
# its f32 step held on 1 layer; deepseek-v2 at full width with 1 of its 60
# layers (5.02 B parameters with the embeddings, 60.3 GB of train state; 2
# layers would be 108 GB), batch 1 x 2,048, its f32 loss and grads (no
# optimizer step: an f32 step's state is 4 x 20 GB) held on that layer
MOE_TRAIN_LAYERS, MOE_TRAIN_F32_LAYERS = 4, 1
MLA_TRAIN_LAYERS, MLA_TRAIN_BATCH, MLA_TRAIN_SEQ = 1, 1, 2048
# the hybrid training cell: hymba-1.5b at full width and depth (1.66 B
# parameters, ~20 GB of train state), 5a's batch, its f32 step held on its
# first 4 layers (global layer 0, windowed 1-3), its profiled step on the
# first 4 layers too: a full-depth step is ~10^6 launches (the Mamba
# recurrence's addcmul_ a step and chunk, forward, recomputed twice and
# backward), too many events for the profiler in a phase's time
HYMBA_TRAIN_F32_LAYERS = HYMBA_TRAIN_PROFILE_LAYERS = 4
# the VLM training cell: llama-3.2-vision at full width, cut to the
# deepest multiple of 5 layers whose train state at 12 bytes a parameter
# leaves VLM_TRAIN_ROOM_GB of the card's 80 GB for activations
# (``vlm_train_cut``: 20 layers, 64.96 GB), 5a's batch, gates at VLM_GATE,
# its f32 step held on its first 5 layers (cross layer 3 among them)
VLM_TRAIN_F32_LAYERS, VLM_TRAIN_ROOM_GB, CARD_GB = 5, 15.0, 80.0
# the RWKV training cell: rwkv6-1.6b at full width and depth (1.609 B
# parameters, 19.3 GB of train state), 5a's batch, its f32 step held on its
# first 2 layers (the plain scan and its backward loop over 4,096 steps,
# ~25 us of host a launch: several seconds a layer)
RWKV_TRAIN_F32_LAYERS = 2
# the one-device mesh (5h): (arch, layers, steps) trained at full width on
# 5a's batch, and the serving cell (arch, layers) with MESH_GEN decode steps
MESH_TRAIN = (("qwen3-4b", 4, 2), ("phi3.5-moe-42b-a6.6b", 1, 1),
              ("rwkv6-1.6b", 2, 1))
MESH_SERVE, MESH_GEN = ("qwen3-4b", 4), 8

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


def device_ms(fn, kernel_name, reps=REPS, tries=3, names=None,
              by_name=None):
    """Device time of one call of ``fn`` in the CUDA kernels whose names
    contain ``kernel_name`` (each kernel's mean over ``reps`` calls, summed
    over the kernels), from the profiler's trace; their full names are
    appended to ``names`` if it is a list, and each one's time is set in
    ``by_name`` if it is a dict.  A trace now and then holds no
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
            ms = {evt.key: evt.device_time_total / evt.count / 1e3
                  for evt in found}
            if names is not None:
                names.extend(sorted(ms))
            if by_name is not None:
                by_name.update(ms)
            return sum(ms.values())
    return None


def kernels_per_call(fn, reps=20, tries=3):
    """What ``reps`` calls of ``fn`` ran on the card, from the profiler's
    trace, per call: ({kernel name: launches the device side recorded},
    calls to the CUDA runtime that start device work: cudaLaunch*,
    cudaMemset*, cudaMemcpy*).  The device side now and then misses a
    short kernel near the start of a trace, and now and then records no
    device work at all while the runtime side shows the launches: such a
    trace is taken again, up to ``tries`` times.  The runtime side sees
    every call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device, api = {}, 0
        for evt in prof.key_averages():
            if evt.count and getattr(evt, "device_time_total", 0):
                device[evt.key] = evt.count / reps
            elif evt.key.startswith(("cudaLaunch", "cudaMemset",
                                     "cudaMemcpy")):
                api += evt.count
        if device or not api:
            break
    return device, api / reps


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
    SASS), forward and backward; fail if a bf16 kernel (``_mma``) has none
    or an f32 kernel (or the backward's D pre-pass) has any.  Their
    registers and spills are ``ptxas``'s lines above."""
    from repro_torch.kernels import _build
    for source, prefix in (("flash_attention", "flash_attention_kernel"),
                           ("flash_attention_bwd", "flash_attention_bwd_")):
        sass = sass_counts(_build.library_path(source), "HMMA")
        if sass is None:
            print(f"  {source}: no cuobjdump, tensor-core instructions not "
                  "counted")
            continue
        kinds = set()
        for name, hmma in sorted(sass.items()):
            if prefix not in name:
                continue
            mma = "_kernel_mma" in name
            if (hmma > 0) != mma:
                raise SystemExit(f"FAIL {name}: {hmma} HMMA instructions")
            kinds.add(mma)
            print(f"  cuobjdump {name}: {hmma} HMMA", flush=True)
        if kinds != {True, False}:
            raise SystemExit(f"FAIL {source}: the SASS lacks the mma or "
                             "the fma kernels")


def bwd_kernels_fault(device, dtype_name):
    """What is wrong with the kernels one ``flash_attention_bwd`` call ran
    ({profiler name: launches}, from ``kernels_per_call``), or None: the
    three of ``BWD_KERNELS``, the dK/dV and dQ kernels those of
    ``BWD_MMA`` in bf16 and none of them in f32."""
    names = list(device)
    if len(names) != len(BWD_KERNELS) or any(
            not any(k in n for n in names) for k in BWD_KERNELS):
        return f"kernels {device}"
    mma = sorted(k for k in BWD_MMA if any(k in n for n in names))
    want = sorted(BWD_MMA) if dtype_name == "bfloat16" else []
    if mma != want:
        return f"{dtype_name} ran {names}, tensor-core kernels {mma}"
    return None


def to_card(arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def hold_kernel(name, wrapper, plain, inputs, nbytes, rate, kernel_name,
                slow=False):
    """Run ``wrapper`` (the kernel) and ``plain`` on the same card inputs,
    fail unless every output is identical, and time both: ``ms`` and
    ``plain_ms`` per call with CUDA events (host overhead included where
    it exceeds the device time), ``device_ms`` the kernel alone.  ``slow``
    times the plain version (a Python loop) over 3 single calls, or, where
    the hold's own call of it took over ``SLOW_S``, by that call alone."""
    import torch
    out = wrapper(*inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(*inputs)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    ok = all(exact(a, b) for a, b in zip(out, ref))
    err = max_abs_err(out, ref)
    if not ok:
        raise SystemExit(f"FAIL {name}: kernel and plain version differ "
                         f"(max abs err {err})")
    ms = time_ms(lambda: wrapper(*inputs), batch=1 if slow else BATCH)
    plain_ms = (ref_s * 1e3 if slow and ref_s > SLOW_S else
                time_ms(lambda: plain(*inputs), *((3, 1) if slow else ())))
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


def drive(cd, jobs, fleet, serving, policy, degradations=()):
    """One simulator run of ``policy``; returns (results, per-call
    schedule seconds, wall seconds, the run's cluster)."""
    from repro_torch.core.simulator import Simulator
    inner = policy.schedule
    ticks = []

    def schedule(now, queue, cluster):
        t0 = time.perf_counter()
        out = inner(now, queue, cluster)
        ticks.append(time.perf_counter() - t0)
        return out

    policy.schedule = schedule
    sim = Simulator(cd, policy, fleet=fleet, seed=0, serving=serving,
                    degradations=degradations)
    t0 = time.perf_counter()
    results = sim.run(jobs)
    return results, ticks, time.perf_counter() - t0, sim.cluster


def synergai(score_fn, rc=None):
    from repro_torch.core.scheduler import SynergAI
    return SynergAI(score_fn=score_fn, recharacterizer=rc)


def online_rc():
    from repro_torch.core.recharacterize import OnlineRecharacterizer
    return OnlineRecharacterizer()


def oracle_rc(cd, fleet, degradations):
    """The true factors installed at t = 0, detection off
    (``benchmarks/scheduler_experiments.py:697-698``): a fresh one a call."""
    def make():
        from repro_torch.core.recharacterize import OnlineRecharacterizer
        from repro_torch.core.simulator import Cluster
        rc = OnlineRecharacterizer(detect=False)
        rc.seed(Cluster(cd, list(fleet)),
                worker_factors={d.worker: d.factor for d in degradations})
        return rc
    return make


def scales(cd, rc):
    """The overlay's final scales, as exact text (``repr`` round-trips every
    float bit for bit)."""
    from repro_torch.core.estimator import profile_overlay
    return json.dumps(profile_overlay(cd, rc.profile).scale, sort_keys=True)


def hold_loop(label, cd, rcs, card_caches, online, cpu, numpy=None):
    """The re-characterizer of the card run against the CPU run's (``cpu``,
    the report of ``cpu_reference``): the same refreshes and bit-equal
    overlay scales; an online run must have refreshed and reclaimed rows on
    the card.  ``rcs`` maps run -> its own re-characterizer (``None`` for a
    stale run); ``numpy`` is the report of ``numpy_reference`` where the
    numpy run was made in a child (else ``rcs["numpy"]`` ran it here)."""
    if rcs["card"] is None:
        return {}
    card = rcs["card"]
    if len({id(rc) for rc in rcs.values()}) != len(rcs):
        raise SystemExit(f"FAIL {label}: runs share a re-characterizer")
    if card.refreshes != cpu["refreshes"]:
        raise SystemExit(f"FAIL {label}: {card.refreshes} refreshes on the "
                         f"card, {cpu['refreshes']} in the device='cpu' run")
    if scales(cd, card) != cpu["scales"]:
        raise SystemExit(f"FAIL {label}: overlay scales differ from the "
                         "device='cpu' run")
    reclaims = sum(c.profile_reclaims for c in card_caches)
    if online and (card.refreshes < 1 or reclaims <= 0):
        raise SystemExit(f"FAIL {label}: {card.refreshes} refreshes and "
                         f"{reclaims} profile reclaims: the refresh path did "
                         "not run")
    return {"refreshes": {"card": card.refreshes, "cpu": cpu["refreshes"],
                          "numpy": (numpy["refreshes"] if numpy
                                    else rcs["numpy"].refreshes)},
            "last_reason": card.last_reason,
            "overlay_scales_equal_to_cpu_run": True,
            "overlay_engines": len(json.loads(scales(cd, card)))}


CACHE_COUNTERS = ("ticks", "rows_uploaded", "bytes_to_device", "fail_masks",
                  "flushes", "profile_reclaims")


def forked(fn, timeout=900):
    """Start ``fn()`` in a forked child while the caller goes on; returns a
    function that waits for its result (picklable), at most ``timeout``
    seconds, and fails if the child failed.  The child must not touch the
    card: it runs a CPU reference run, on one thread, its cyclic garbage
    collector off (the parent's CUDA tensors are never freed there), and
    leaves through ``os._exit``."""
    import gc
    import multiprocessing
    import torch
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def child():
        gc.disable()
        torch.set_num_threads(1)
        try:
            send.send(("ok", fn()))
        except BaseException as e:   # reported, and the parent fails
            send.send(("error", f"{type(e).__name__}: {e}"))

    sys.stdout.flush()
    sys.stderr.flush()
    proc = ctx.Process(target=child, daemon=True)
    proc.start()
    send.close()

    def wait():
        if not recv.poll(timeout):
            proc.kill()
            proc.join()
            raise SystemExit(f"FAIL: a CPU reference run took over "
                             f"{timeout} s")
        try:
            kind, value = recv.recv()
        except EOFError:
            kind, value = "error", "the child ended without a result"
        proc.join()
        if kind != "ok":
            raise SystemExit(f"FAIL: a CPU reference run failed: {value} "
                             f"(exit code {proc.exitcode})")
        return value
    return wait


def cpu_reference(cd, jobs, fleet, serving, policy, degradations, rc):
    """The run of ``policy`` on the kernels' plain versions (a forked
    child's work): what the checks compare with the card run, as plain
    data: the canonical results, wall seconds, edge energy, the launches it
    made (none, if the plain versions were used), each score cache's
    counters, and its re-characterizer's refreshes and overlay scales."""
    from repro_torch.core.energy import edge_energy
    from repro_torch.kernels import scheduler_score as ss
    from repro_torch.launch.schedule import caches_of
    wrappers = (ss.scheduler_score, ss.scheduler_score_v2, ss.tick_score,
                ss.greedy_place)
    before = sum(w.launches for w in wrappers)
    res, _, wall, cluster = drive(cd, jobs, fleet, serving, policy,
                                  degradations)
    caches = caches_of(policy)
    return {"canon": canon(res), "wall": wall,
            "energy": edge_energy(cluster),
            "launches": sum(w.launches for w in wrappers) - before,
            "counters": {key: [getattr(c, key, None) for c in caches]
                         for key in CACHE_COUNTERS},
            "refreshes": rc.refreshes if rc else None,
            "scales": scales(cd, rc) if rc else None}


def numpy_reference(cd, jobs, fleet, serving, policy, degradations, rc):
    """The run of the default numpy ``policy`` (a forked child's work), as
    plain data: its results, per-call schedule seconds, wall seconds, its
    re-characterizer's refreshes, and its cluster's edge energy and offload
    fraction (the cluster itself does not pickle)."""
    from repro_torch.core.energy import edge_energy, offload_fraction
    res, ticks, wall, cluster = drive(cd, jobs, fleet, serving, policy,
                                      degradations)
    return {"results": res, "ticks": ticks, "wall": wall,
            "refreshes": rc.refreshes if rc else None,
            "energy": edge_energy(cluster),
            "offload": offload_fraction(res, cluster)}


class Children:
    """Forked children (``forked``) all started at the start of a phase,
    from the main thread, that take turns: at most ``limit`` of them run at
    once, in the order they were started (the runs the phase needs first
    finish first); the rest wait in the child, idle.  So the host work of
    the references runs beside the card runs instead of before them."""

    def __init__(self, limit):
        import multiprocessing
        ctx = multiprocessing.get_context("fork")
        self.limit = limit
        self.turn = ctx.Condition()
        self.next = ctx.RawValue("i", 0)
        self.running = ctx.RawValue("i", 0)
        self.started = 0

    def start(self, fn):
        """Fork a child for ``fn()``; returns ``forked``'s waiter."""
        ticket = self.started
        self.started += 1

        def in_turn():
            with self.turn:
                self.turn.wait_for(lambda: self.next.value == ticket
                                   and self.running.value < self.limit)
                self.next.value += 1
                self.running.value += 1
                self.turn.notify_all()
            try:
                return fn()
            finally:
                with self.turn:
                    self.running.value -= 1
                    self.turn.notify_all()
        return forked(in_turn)


def start_references(children, cd, jobs, fleet, serving, make_policy,
                     cpu_score_fn, degradations=(), make_rc=None):
    """Start a run's CPU reference (``make_policy(cpu_score_fn(), rc)`` on
    the kernels' plain versions) and its numpy reference
    (``make_policy(None, rc)``) in children; returns their waiters and the
    run's re-characterizers, one fresh from ``make_rc`` for each of the
    numpy, card and CPU runs (``None`` without it)."""
    rcs = {k: make_rc() if make_rc else None for k in ("numpy", "card",
                                                       "cpu")}
    cpu = children.start(lambda: cpu_reference(
        cd, jobs, fleet, serving, make_policy(cpu_score_fn(), rcs["cpu"]),
        degradations, rcs["cpu"]))
    numpy = children.start(lambda: numpy_reference(
        cd, jobs, fleet, serving, make_policy(None, rcs["numpy"]),
        degradations, rcs["numpy"]))
    return types.SimpleNamespace(cpu=cpu, numpy=numpy, rcs=rcs)


def main_path_references(children, cd, fleet, jobs, serving, v2,
                         degradations=(), make_rc=None):
    from repro_torch.core.scoring import make_torch_score_fn
    return start_references(
        children, cd, jobs, fleet, serving, synergai,
        lambda: make_torch_score_fn(v2=v2, device="cpu"), degradations,
        make_rc)


def resident_references(children, cd, fleet, jobs, serving, make_policy,
                        degradations=(), make_rc=None):
    from repro_torch.core.scoring import make_torch_score_fn
    return start_references(
        children, cd, jobs, fleet, serving, make_policy,
        lambda: make_torch_score_fn(device_cache=True, device="cpu"),
        degradations, make_rc)


def main_path_run(label, cd, fleet, jobs, serving, v2, kernel, refs,
                  degradations=(), make_rc=None, tag="main_path"):
    """A scoring-kernel path (v1, or v2 with ``v2``) on the card, held to
    its CPU and numpy references (``refs``, from ``main_path_references``
    with the same arguments).  Returns (launches, mean rows a scoring tick,
    the card's summary)."""
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.launch.schedule import caches_of
    rcs = refs.rcs
    card_fn = make_torch_score_fn(v2=v2)
    card_pol = synergai(card_fn, rcs["card"])
    kernel.launches = 0
    res_card, ticks_card, wall_card, _ = drive(cd, jobs, fleet, serving,
                                               card_pol, degradations)
    launches = kernel.launches

    cpu, numpy = refs.cpu(), refs.numpy()
    res_np, ticks_np, wall_np = (numpy["results"], numpy["ticks"],
                                 numpy["wall"])
    if cpu["launches"]:
        raise SystemExit(f"FAIL {label}: the CPU run launched a kernel")

    if launches <= 0 or launches < card_fn.calls:
        raise SystemExit(f"FAIL {label}: {launches} launches for "
                         f"{card_fn.calls} scoring ticks")
    if canon(res_card) != cpu["canon"]:
        raise SystemExit(f"FAIL {label}: card results differ from the "
                         "device='cpu' run")
    if len(res_card) != len(jobs):
        raise SystemExit(f"FAIL {label}: {len(res_card)} results")
    caches = caches_of(card_pol)
    if ([c.profile_reclaims for c in caches]
            != cpu["counters"]["profile_reclaims"]):
        raise SystemExit(f"FAIL {label}: profile reclaims differ from the "
                         "device='cpu' run")
    loop = hold_loop(label, cd, rcs, caches, make_rc is online_rc, cpu,
                     numpy)
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
        "wall_s": {"numpy": wall_np, "card": wall_card, "cpu": cpu["wall"]},
        "schedule_calls": len(ticks_card),
        "schedule_ms_per_call": {"numpy": statistics.fmean(ticks_np) * 1e3,
                                 "card": statistics.fmean(ticks_card) * 1e3},
        "card_scoring_ms_per_tick": split,
    }
    if caches:
        line["profile_reclaims"] = sum(c.profile_reclaims for c in caches)
    line.update(loop)
    print(f"{tag} " + json.dumps(line), flush=True)
    return launches, card_fn.rows / calls, s_card


def resident_run(label, cd, fleet, jobs, serving, make_policy, refs,
                 degradations=(), make_rc=None, tag="main_path"):
    """The device-resident path: ``make_policy(score_fn, rc)`` on the card,
    held to its CPU and numpy references (``refs``, from
    ``resident_references`` with the same arguments).  Returns a namespace:
    the launches of each tick kernel, the mean (J, cap) of the card's ticks,
    the card's summary, its results and cluster, and the numpy
    reference's report."""
    from repro_torch.core import devicecache
    from repro_torch.core.energy import edge_energy
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.kernels import scheduler_score as ss
    from repro_torch.launch.schedule import caches_of
    rcs = refs.rcs

    # per device_tick: queue length, pool rows, host-clock seconds; and the
    # rows uploaded by the syncs in which a refresh reclaimed rows
    tick_log = []
    reupload = [0]
    inner = devicecache.DeviceScoreCache.device_tick
    inner_sync = devicecache.DeviceScoreCache.sync

    def device_tick(self, slots, *args, **kw):
        t0 = time.perf_counter()
        out = inner(self, slots, *args, **kw)
        tick_log.append((len(slots), self._d_cap, time.perf_counter() - t0))
        return out

    def sync(self, *args, **kw):
        before = (self.profile_reclaims, self.rows_uploaded)
        out = inner_sync(self, *args, **kw)
        if self.profile_reclaims > before[0]:
            reupload[0] += self.rows_uploaded - before[1]
        return out

    card_pol = make_policy(make_torch_score_fn(device_cache=True),
                           rcs["card"])
    devicecache.DeviceScoreCache.device_tick = device_tick
    devicecache.DeviceScoreCache.sync = sync
    try:
        ss.tick_score.launches = ss.greedy_place.launches = 0
        res_card, ticks_card, wall_card, cluster_card = drive(
            cd, jobs, fleet, serving, card_pol, degradations)
        launches = {"tick_score_kernel": ss.tick_score.launches,
                    "greedy_place_kernel": ss.greedy_place.launches}
    finally:
        devicecache.DeviceScoreCache.device_tick = inner
        devicecache.DeviceScoreCache.sync = inner_sync

    cpu, numpy = refs.cpu(), refs.numpy()
    res_np, ticks_np, wall_np = (numpy["results"], numpy["ticks"],
                                 numpy["wall"])
    if cpu["launches"]:
        raise SystemExit(f"FAIL {label}: the CPU run launched a kernel")

    caches = caches_of(card_pol)
    ticks = sum(c.ticks for c in caches)
    if ticks <= 0 or any(n != ticks for n in launches.values()):
        raise SystemExit(f"FAIL {label}: launches {launches} for {ticks} "
                         "device ticks")
    if canon(res_card) != cpu["canon"]:
        raise SystemExit(f"FAIL {label}: card results differ from the "
                         "device='cpu' run")
    if edge_energy(cluster_card) != cpu["energy"]:
        raise SystemExit(f"FAIL {label}: edge energy differs from the "
                         "device='cpu' run")
    for key in CACHE_COUNTERS:
        if sum(getattr(c, key) for c in caches) != sum(cpu["counters"][key]):
            raise SystemExit(f"FAIL {label}: counter {key} differs from the "
                             "device='cpu' run")
    loop = hold_loop(label, cd, rcs, caches, make_rc is online_rc, cpu,
                     numpy)
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
        "wall_s": {"numpy": wall_np, "card": wall_card, "cpu": cpu["wall"]},
        "schedule_calls": len(ticks_card),
        "schedule_ms_per_call": {"numpy": statistics.fmean(ticks_np) * 1e3,
                                 "card": statistics.fmean(ticks_card) * 1e3},
        "device_tick_ms": statistics.fmean(t for _, _, t in tick_log) * 1e3,
        "bytes_to_device_per_tick":
            sum(c.bytes_to_device for c in caches) / ticks,
        "rows_uploaded": sum(c.rows_uploaded for c in caches),
        "fail_masks": sum(c.fail_masks for c in caches),
        "flushes": sum(c.flushes for c in caches),
        "profile_reclaims": sum(c.profile_reclaims for c in caches),
        "rows_reuploaded_after_refresh": reupload[0],
    }
    line.update(loop)
    print(f"{tag} " + json.dumps(line), flush=True)
    return types.SimpleNamespace(
        launches=launches, mean_j=mean_j, mean_cap=mean_cap, summary=s_card,
        results=res_card, cluster=cluster_card, numpy=numpy)


def host_policies():
    """SLO-MAEL and the five baselines by their names (``SLO-MAEL``, ``RR``,
    ...): the launcher's host policies."""
    from repro_torch.launch.schedule import HOST_POLICIES
    return {cls.name: cls for cls in HOST_POLICIES.values()}


def ratios(violations):
    """The paper's two headlines (``examples/scheduler_comparison.py``):
    SLO-MAEL's and the five baselines' mean violations over SynergAI's."""
    syn = max(1, violations["SynergAI"])
    return {"slo_mael_over_synergai": violations["SLO-MAEL"] / syn,
            "baselines_over_synergai":
                statistics.fmean(violations[n] for n in BASELINES) / syn}


def host_run(cd, jobs, fleet, name):
    """One host policy's run over ``jobs`` in job mode (a forked child's
    work): its result count, summary, wall and per-call seconds."""
    from repro_torch.core.metrics import summarize
    res, ticks, wall, _ = drive(cd, jobs, fleet, "job",
                                host_policies()[name]())
    return {"results": len(res), "summary": summarize(res), "wall": wall,
            "schedule_ms_per_call": statistics.fmean(ticks) * 1e3}


def start_comparison(children, cd, fleet, jobs):
    """Start SLO-MAEL's and the five baselines' runs in children."""
    return {name: children.start(lambda name=name: host_run(cd, jobs, fleet,
                                                             name))
            for name in host_policies()}


def comparison(jobs, fleet, synergai_run, host):
    """SLO-MAEL and the five baselines on the host over the 10k-job MMPP
    jobs (``host``: ``start_comparison``'s waiters), beside the
    job-resident SynergAI run on the card."""
    rows = {"SynergAI": {
        "violations": synergai_run.summary["violations"],
        "goodput_jps": synergai_run.summary["goodput_jps"],
        "device": "card"}}
    for name, wait in host.items():
        run = wait()
        s = run["summary"]
        if run["results"] != len(jobs) or not math.isfinite(s["e2e_avg_s"]):
            raise SystemExit(f"FAIL comparison {name}: {run['results']} "
                             f"results, {s['e2e_avg_s']} e2e")
        rows[name] = {"violations": s["violations"],
                      "goodput_jps": s["goodput_jps"], "device": "host",
                      "wall_s": run["wall"],
                      "schedule_ms_per_call": run["schedule_ms_per_call"]}
    line = {"run": "mmpp-10k", "jobs": len(jobs), "pools": len(fleet),
            "policies": rows,
            **ratios({k: v["violations"] for k, v in rows.items()}),
            "paper": {"slo_mael_over_synergai": 2.4,
                      "baselines_over_synergai": 7.1}}
    print("comparison " + json.dumps(line), flush=True)


def paper_references(cd):
    """The runs of the paper's experiments that do not touch the card (a
    forked child's work): by (experiment, policy, seed) each host policy's
    and numpy SynergAI's violations, and by (experiment, seed) the
    canonical results of resident SynergAI's run on the CPU."""
    from repro_torch.core.job import make_experiment
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.core.simulator import Simulator
    policies = host_policies()
    out = {"violations": {}, "cpu": {}}
    for exp, demand, freq in EXPERIMENTS:
        for seed in EXPERIMENT_SEEDS:
            out["cpu"][exp, seed] = canon(Simulator(cd, SynergAI(
                score_fn=make_torch_score_fn(device_cache=True,
                                             device="cpu")),
                seed=seed).run(make_experiment(cd, demand, freq,
                                               seed=seed)))
            for name in (*policies, "SynergAI-numpy"):
                jobs = make_experiment(cd, demand, freq, seed=seed)
                pol = (SynergAI() if name == "SynergAI-numpy"
                       else policies[name]())
                res = Simulator(cd, pol, seed=seed).run(jobs)
                if len(res) != len(jobs):
                    raise SystemExit(f"FAIL paper {exp} {name}: "
                                     f"{len(res)} results")
                out["violations"][exp, name, seed] = summarize(
                    res)["violations"]
    return out


def paper_experiments(cd, refs):
    """The paper's three experiments x five seeds, all seven policies, with
    SynergAI on the resident backend on the card (held to the same run on
    the CPU, its launches to its ticks) and, beside it, numpy SynergAI;
    every run but the card's from ``refs`` (``paper_references``' waiter).
    Returns the tick kernels' launches."""
    from repro_torch.core.job import make_experiment
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.core.simulator import Simulator
    from repro_torch.kernels import scheduler_score as ss
    policies = host_policies()
    refs = refs()
    totals = {name: 0 for name in (*policies, "SynergAI", "SynergAI-numpy")}
    by_exp = {}
    launches = {"tick_score_kernel": 0, "greedy_place_kernel": 0}
    ticks = 0
    for exp, demand, freq in EXPERIMENTS:
        by_exp[exp] = {}
        for name in totals:
            v = 0
            for seed in EXPERIMENT_SEEDS:
                if name != "SynergAI":
                    v += refs["violations"][exp, name, seed]
                    continue
                jobs = make_experiment(cd, demand, freq, seed=seed)
                pol = SynergAI(score_fn=make_torch_score_fn(
                    device_cache=True))
                ss.tick_score.launches = ss.greedy_place.launches = 0
                res = Simulator(cd, pol, seed=seed).run(jobs)
                got = (ss.tick_score.launches, ss.greedy_place.launches)
                if got != (pol.cache.ticks,) * 2 or pol.cache.ticks <= 0:
                    raise SystemExit(f"FAIL paper {exp} seed {seed}: "
                                     f"launches {got} for "
                                     f"{pol.cache.ticks} device ticks")
                if canon(res) != refs["cpu"][exp, seed]:
                    raise SystemExit(f"FAIL paper {exp} seed {seed}: "
                                     "card results differ from the "
                                     "device='cpu' run")
                launches["tick_score_kernel"] += got[0]
                launches["greedy_place_kernel"] += got[1]
                ticks += pol.cache.ticks
                if len(res) != len(jobs):
                    raise SystemExit(f"FAIL paper {exp} {name}: "
                                     f"{len(res)} results")
                v += summarize(res)["violations"]
            by_exp[exp][name] = v
            totals[name] += v
    line = {"experiments": [e for e, _, _ in EXPERIMENTS],
            "seeds": list(EXPERIMENT_SEEDS), "jobs_each": 24,
            "violations": by_exp, "totals": totals,
            "synergai_device_ticks": ticks, "launches": launches,
            **ratios(totals),
            "numpy": ratios({**totals, "SynergAI": totals["SynergAI-numpy"]}),
            "paper": {"slo_mael_over_synergai": 2.4,
                      "baselines_over_synergai": 7.1}}
    print("paper " + json.dumps(line), flush=True)
    return launches


def energy_line(label, run):
    """The energy accounting of a resident run, card against numpy: the
    numpy run's edge energy and offload fraction come from its child, and
    both runs' energies are normalized as ``normalized_edge_energy`` does
    (each pool by its peak over the runs)."""
    from repro_torch.core.energy import edge_energy, offload_fraction
    energy = {"card": edge_energy(run.cluster), "numpy": run.numpy["energy"]}
    peak = {p: max(e.get(p, 0.0) for e in energy.values())
            for p in set().union(*energy.values())}
    norm = {k: {p: (0.0 if peak[p] <= 0.0 else v / peak[p])
                for p, v in e.items()} for k, e in energy.items()}
    pools = sorted(norm["card"])
    line = {
        "run": label, "edge_pools": len(pools),
        "normalized_edge_energy": {
            k: {"mean": statistics.fmean(v.values()), "min": min(v.values())}
            for k, v in norm.items()},
        "normalized_max_abs_diff_card_vs_numpy": max(
            abs(norm["card"][p] - norm["numpy"][p]) for p in pools),
        "edge_energy_j": {k: sum(e.values()) for k, e in energy.items()},
        "offload_fraction": {
            "card": offload_fraction(run.results, run.cluster),
            "numpy": run.numpy["offload"]},
    }
    if not all(math.isfinite(x) for x in (*line["edge_energy_j"].values(),
                                          *line["offload_fraction"].values())):
        raise SystemExit(f"FAIL energy {label}: non-finite {line}")
    print("energy " + json.dumps(line), flush=True)


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


def scheduling_path():
    """Phases 3, 3f and 3g; returns what the kernels line needs."""
    from repro_torch.core.hierarchy import HierarchicalSynergAI
    from repro_torch.core.offline import characterize
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.workers import synth_fleet
    from repro_torch.core.workload import (regional_scenario, scenario,
                                           synth_degradations)
    from repro_torch.kernels import scheduler_score as ss
    # 3. the scheduling path at full size.  Every run's inputs first, then
    # every run's CPU and numpy references and 3g's host policies in
    # forked children that take turns beside the card runs (``Children``)
    cd = characterize()
    fleet = synth_fleet(*POOLS)
    mmpp = scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet, seed=0)
    streaming = scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet, seed=0,
                         serving="batched", streaming=(2.0, 2.5))
    regions = synth_fleet(*POOLS, regions=3)
    regional = regional_scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=regions,
                                 seed=0)
    drift_jobs = scenario(cd, "drift", n_jobs=N_JOBS, fleet=regions, seed=0)
    degs = synth_degradations(regions, drift_jobs[-1].arrival, **DRIFT)

    def energy_policy(fn, rc):
        return SynergAI(score_fn=fn, recharacterizer=rc, energy_weight=0.5)

    def hier_policy(fn, rc):
        return HierarchicalSynergAI(score_fn=fn, recharacterizer=rc)

    # (label, run, fixed arguments, keyword arguments), in the card's order
    runs = [
        ("job-v1", "main", (fleet, mmpp, "job", False), {}),
        ("batched-streaming-v2", "main", (fleet, streaming, "batched", True),
         {}),
        ("job-resident", "resident", (fleet, mmpp, "job", synergai), {}),
        ("batched-streaming-resident", "resident",
         (fleet, streaming, "batched", energy_policy), {}),
        ("hier-resident", "resident", (regions, regional, "job",
                                       hier_policy), {}),
    ] + [
        (f"drift-resident-{name}", "resident",
         (regions, drift_jobs, "job", synergai),
         dict(degradations=degs, make_rc=make_rc, tag="drift"))
        for name, make_rc in (("stale", None), ("online", online_rc),
                              ("oracle", oracle_rc(cd, regions, degs)))
    ] + [
        ("drift-v2-online", "main", (regions, drift_jobs, "job", True),
         dict(degradations=degs, make_rc=online_rc, tag="drift")),
        ("drift-hier-resident-online", "resident",
         (regions, drift_jobs, "job", hier_policy),
         dict(degradations=degs, make_rc=online_rc, tag="drift")),
    ]
    t_fork = time.perf_counter()
    children = Children(max(1, (os.cpu_count() or 2) - 2))
    refs = {}
    for label, kind, args, kw in runs:
        start = main_path_references if kind == "main" else \
            resident_references
        refs[label] = start(children, cd, *args,
                            **{k: v for k, v in kw.items() if k != "tag"})
    host = start_comparison(children, cd, fleet, mmpp)
    paper = children.start(lambda: paper_references(cd))
    print(f"children: {children.started} CPU and numpy references and host "
          f"policies forked in {time.perf_counter() - t_fork:.1f} s, "
          f"{children.limit} at a time", flush=True)

    def run(label, kernel=None):
        kind, args, kw = next((k, a, w) for name, k, a, w in runs
                              if name == label)
        if kind == "main":
            return main_path_run(label, cd, *args, kernel, refs[label], **kw)
        return resident_run(label, cd, *args, refs[label], **kw)

    main_path = {
        "scheduler_score": run("job-v1", ss.scheduler_score),
        "scheduler_score_v2": run("batched-streaming-v2",
                                  ss.scheduler_score_v2),
    }
    resident = {name: run(name) for name in ("job-resident",
                                             "batched-streaming-resident")}
    energy_line("batched-streaming-resident",
                resident["batched-streaming-resident"])
    resident["hier-resident"] = run("hier-resident")

    tick_stages(cd, fleet, mmpp[:3000])

    # 3f. drift: the same 64 pools over three regions, a third of the edge
    # pools slowed ~5x from a third of the way in; stale, online and oracle
    # re-characterization through the resident tick, online through v2, and
    # online under the hierarchy (one re-characterizer for every region)
    t_drift = time.perf_counter()
    print(f"drift: {len(degs)} of {len(regions)} pools degraded, factors "
          f"{min(d.factor for d in degs):.3f}-"
          f"{max(d.factor for d in degs):.3f}, onsets "
          f"{min(d.at for d in degs):.1f}-{max(d.at for d in degs):.1f} s "
          f"of {drift_jobs[-1].arrival:.1f} s", flush=True)
    drift = {name: run(f"drift-resident-{name}")
             for name in ("stale", "online", "oracle")}
    drift_v2 = run("drift-v2-online", ss.scheduler_score_v2)
    drift["hier-online"] = run("drift-hier-resident-online")
    stale_v = drift["stale"].summary["violations"]
    online_v = drift["online"].summary["violations"]
    if not online_v < stale_v:
        raise SystemExit(f"FAIL drift: {online_v} violations online, "
                         f"{stale_v} stale")
    print("drift_headline " + json.dumps({
        "violations": {k: r.summary["violations"] for k, r in drift.items()}
        | {"v2-online": drift_v2[2]["violations"]},
        "stale_over_online": stale_v / max(1, online_v),
        "seconds": time.perf_counter() - t_drift}), flush=True)

    # 3g. the paper's comparison policies: SLO-MAEL and the five baselines
    # on the host beside the job-resident run; then the paper's experiments
    t_cmp = time.perf_counter()
    comparison(mmpp, fleet, resident["job-resident"], host)
    paper_launches = paper_experiments(cd, paper)
    print(f"comparison: {time.perf_counter() - t_cmp:.1f} s", flush=True)
    return types.SimpleNamespace(
        fleet=fleet, main_path=main_path, resident=resident, drift=drift,
        drift_v2=drift_v2, paper_launches=paper_launches)


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


def hold_flash(B, S, H, K, hd, window, causal, dtype_name, rate):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dtype = getattr(torch, dtype_name)
    inputs = attn_inputs((B, S, H, hd), (B, S, K, hd), dtype, S + hd)
    ok = None
    if window is not None:
        pos = torch.arange(S, device="cuda")
        ok = pos[:, None] - pos[None, :] < window
        if causal:
            ok &= pos[None, :] <= pos[:, None]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=ok, is_causal=causal and ok is None,
            enable_gqa=True).transpose(1, 2)

    def kernel(q, k, v):
        return fa.flash_attention(q, k, v, causal=causal, window=window)

    esize = inputs[0].element_size()
    label = (f"flash_attention (B, S, H, K, hd, window, causal)="
             f"{(B, S, H, K, hd, window, causal)} {dtype_name}")
    r = hold_attention(
        label, "flash_attention_kernel", kernel,
        lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=causal,
                                                 window=window),
        sdpa, inputs, dtype_name,
        4 * B * H * visible_pairs(S, S, causal, window) * hd,
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
    name = (f"decode_attention{label} (B, S, H, K, hd, k_valid)="
            f"{(B, S, H, K, hd, k_valid)} {dtype_name}")
    r = hold_attention(
        name, "decode_attention_", da.decode_attention,
        da.decode_attention_plain, sdpa, (q, k, v, k_valid), dtype_name,
        4 * B * H * kv_end * hd,
        esize * (2 * B * kv_end * K * hd + 2 * B * H * hd), rate)
    # one launch a call, the same bits on every call, the tickets back at 0
    outs = [da.decode_attention(q, k, v, k_valid)
            for _ in range(DECODE_REPEATS)]
    torch.cuda.synchronize()
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise SystemExit(f"FAIL {name}: {DECODE_REPEATS} calls differ")
    if not da.tickets_at_zero(q.device):
        raise SystemExit(f"FAIL {name}: the ticket counters are not 0")
    device, api = kernels_per_call(
        lambda: da.decode_attention(q, k, v, k_valid))
    if (api != 1 or len(device) != 1
            or "decode_attention_" not in next(iter(device))):
        raise SystemExit(f"FAIL {name}: {api} launches a call, kernels "
                         f"{device}")
    r["launches_per_call"] = api
    r["n_split"] = da.plan_splits(B, K, H // K, kv_end, hd)
    r["split_ends"] = [e for _, e in da.split_keys(r["n_split"], kv_end)]
    print(f"hold {name}: {DECODE_REPEATS} calls bit-identical, one kernel a "
          f"call, {r['n_split']} splits", flush=True)
    return r


def hold_decode_lse(B, S, H, K, hd, k_valid, dtype_name, rate):
    """The decode kernel's log-sum-exp instance: its f32 output rounded to
    the dtype bit-equal to the instance without lse, its lse within
    ``DECODE_LSE_TOL`` of the plain version's ``torch.logsumexp`` of the
    masked scores, one launch a call, the tickets back at 0; both
    instances timed."""
    import torch
    from repro_torch.kernels import decode_attention as da
    dtype = getattr(torch, dtype_name)
    q, k, v = attn_inputs((B, 1, H, hd), (B, S, K, hd), dtype, S + 3 * hd)
    name = (f"decode_attention lse (B, S, H, K, hd, k_valid)="
            f"{(B, S, H, K, hd, k_valid)} {dtype_name}")
    before = da.decode_attention.launches
    out, lse = da.decode_attention(q, k, v, k_valid, return_lse=True)
    plain_out = da.decode_attention(q, k, v, k_valid)
    torch.cuda.synchronize()
    want_out, want_lse = da.decode_attention_plain(q, k, v, k_valid,
                                                   return_lse=True)
    lse_err = float((lse - want_lse).abs().max())
    out_err = float((out - want_out).abs().max())
    kv_end = min(k_valid, S) if k_valid >= 1 else S
    esize = q.element_size()
    bound_ms, bound_by = attn_bound(
        4 * B * H * kv_end * hd,
        esize * (2 * B * kv_end * K * hd + B * H * hd) + 4 * B * H * hd
        + 4 * B * H, dtype_name, rate)
    r = {"bit_equal_to_no_lse": bool(torch.equal(out.to(dtype), plain_out)),
         "lse_max_abs_err": lse_err, "out_max_abs_err": out_err,
         "launches": da.decode_attention.launches - before,
         "tickets_at_zero": da.tickets_at_zero(q.device),
         "lse_finite": bool(torch.isfinite(lse).all()),
         "ms": time_ms(lambda: da.decode_attention(q, k, v, k_valid,
                                                   return_lse=True)),
         "no_lse_ms": time_ms(lambda: da.decode_attention(q, k, v, k_valid)),
         "device_ms": device_ms(lambda: da.decode_attention(
             q, k, v, k_valid, return_lse=True), "decode_attention_"),
         "no_lse_device_ms": device_ms(lambda: da.decode_attention(
             q, k, v, k_valid), "decode_attention_"),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "n_split": da.plan_splits(B, K, H // K, kv_end, hd)}
    print(f"hold {name}: " + json.dumps(r), flush=True)
    if (not r["bit_equal_to_no_lse"] or lse_err > DECODE_LSE_TOL
            or r["launches"] != 2 or not r["tickets_at_zero"]
            or not r["lse_finite"]):
        raise SystemExit(f"FAIL {name}: {r}")
    return r


def stream_overlap(prof, kernel_name):
    """From a profiler trace: the launches of ``kernel_name`` on each stream,
    and how many of them ran, for part of their time at least, while a
    launch on another stream ran."""
    from torch.autograd import DeviceType
    spans = [(getattr(evt, "device_resource_id", None) or evt.thread,
              evt.time_range.start, evt.time_range.end)
             for evt in prof.events()
             if evt.device_type == DeviceType.CUDA and kernel_name in evt.name]
    per_stream = {}
    for st, _, _ in spans:
        per_stream[st] = per_stream.get(st, 0) + 1
    overlapped = sum(
        any(o != st and a < e and b < d for o, b, e in spans)
        for st, a, d in spans)
    return {"launches_by_stream": sorted(per_stream.values()),
            "overlapped": overlapped}


def hold_decode_streams():
    """Two streams of one device run ``decode_attention`` at once on
    different inputs, ``STREAM_CALLS`` calls each: every output bit-equal
    to the same call run alone, the tickets (one buffer a stream) back at
    0.  Both streams wait behind a spin (``STREAM_HOLD_CYCLES``) until every
    call is queued, so that their kernels meet; the profiler's trace says
    how many launches ran while one on the other stream did.  A control
    runs the same calls with one
    ticket buffer forced on both streams (the layout before the buffers
    were kept per stream) and reports, without failing, what it gave."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import decode_attention as da
    shapes = (DECODE_HOLDS[-1], DECODE_HOLDS[4])
    inputs = [attn_inputs((B, 1, H, hd), (B, S, K, hd), torch.bfloat16, i)
              + [kv] for i, (B, S, H, K, hd, kv) in enumerate(shapes)]
    alone = [da.decode_attention(*x) for x in inputs]
    streams = [torch.cuda.Stream() for _ in inputs]
    torch.cuda.synchronize()

    def both_streams():
        outs = [[] for _ in inputs]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for st in streams:
                with torch.cuda.stream(st):
                    torch.cuda._sleep(STREAM_HOLD_CYCLES)
            for _ in range(STREAM_CALLS):
                for i, (x, st) in enumerate(zip(inputs, streams)):
                    with torch.cuda.stream(st):
                        outs[i].append(da.decode_attention(*x))
            torch.cuda.synchronize()
        equal = [all(torch.equal(o, alone[i]) for o in outs[i])
                 for i in range(len(inputs))]
        return equal, stream_overlap(prof, "decode_attention")

    equal, overlap = both_streams()
    zero = da.tickets_at_zero(inputs[0][0].device)
    per_stream = da._counters
    shared = torch.zeros(4096, dtype=torch.int32, device="cuda")
    da._counters = lambda device, stream, n: shared
    try:
        c_equal, c_overlap = both_streams()
    finally:
        da._counters = per_stream
    control = {"bit_equal_to_alone": c_equal,
               "tickets_at_zero": not bool(shared.any()),
               "overlap": c_overlap}
    line = {"shapes": [list(x) for x in shapes], "calls_per_stream":
            STREAM_CALLS, "bit_equal_to_alone": equal,
            "tickets_at_zero": zero, "overlap": overlap,
            "control_one_shared_buffer": control}
    print("hold decode_attention two streams: " + json.dumps(line),
          flush=True)
    if not all(equal) or not zero:
        raise SystemExit(f"FAIL decode_attention on two streams: {line}")


def sdpa_mask(S, window, causal):
    """The boolean mask SDPA needs for a windowed shape (None otherwise:
    ``is_causal`` or no mask)."""
    import torch
    if window is None:
        return None
    pos = torch.arange(S, device="cuda")
    ok = pos[:, None] - pos[None, :] < window
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    return ok


def hold_flash_bwd(B, S, H, K, hd, window, causal, dtype_name, rate):
    """Phase 2h at one shape: the forward kernel as a training step calls
    it (writing its lse), its output within ``ATTN_TOL`` of
    ``flash_attention_plain`` and its lse against ``torch.logsumexp`` of
    the masked scores; ``flash_attention_bwd``
    against ``flash_attention_bwd_plain`` on the same (q, k, v, out, lse,
    dout), dq, dk and dv each within ``BWD_REL`` of its max |plain|; two
    calls bit-identical; the profiler's kernels of one call exactly the
    three of ``BWD_KERNELS``, once each, in bf16 the tensor-core ones of
    ``BWD_MMA`` and in f32 the FMA ones.  Times: the kernel (device and per
    call), the plain version and the library yardstick, the backward of
    ``scaled_dot_product_attention`` with ``enable_gqa`` timed alone (its
    forward done once, ``retain_graph``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    dtype = getattr(torch, dtype_name)
    q, k, v = attn_inputs((B, S, H, hd), (B, S, K, hd), dtype, S + hd + 1)
    rng = np.random.default_rng(S + hd + 2)
    dout = torch.from_numpy(rng.standard_normal((B, S, H, hd),
                                                dtype=np.float32)).to(
        device="cuda", dtype=dtype)
    label = (f"flash_attention_bwd (B, S, H, K, hd, window, causal)="
             f"{(B, S, H, K, hd, window, causal)} {dtype_name}")
    out, lse = fa._launch_forward(q, k, v, causal, window, True)
    out_plain, lse_plain = fa.flash_attention_plain(
        q, k, v, causal=causal, window=window, return_lse=True)
    rtol, atol = ATTN_TOL[dtype_name]
    out_err = (out.float() - out_plain.float()).abs()
    if not bool((out_err <= atol + rtol * out_plain.float().abs()).all()):
        raise SystemExit(f"FAIL {label}: the forward with lse is off the "
                         f"plain version by up to {float(out_err.max())}")
    rtol, atol = LSE_TOL
    lse_err = (lse - lse_plain).abs()
    if int((lse_err > atol + rtol * lse_plain.abs()).sum()):
        raise SystemExit(f"FAIL {label}: the forward's lse is off "
                         f"logsumexp by up to {float(lse_err.max())}")
    del out_plain, lse_plain
    inputs = (q, k, v, out, lse, dout)

    def kernel():
        return fa.flash_attention_bwd(*inputs, causal=causal, window=window)

    def plain():
        return fa.flash_attention_bwd_plain(*inputs, causal=causal,
                                            window=window)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    rel = [float((a.float() - b.float()).abs().max())
           / float(b.float().abs().max()) for a, b in zip(got, want)]
    max_abs = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    if not finite or max(rel) > BWD_REL[dtype_name]:
        raise SystemExit(f"FAIL {label}: dq, dk, dv off the plain version "
                         f"by {rel} of max |plain| (bound "
                         f"{BWD_REL[dtype_name]}), finite {finite}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise SystemExit(f"FAIL {label}: two calls differ")
    del got, again, want
    # the runtime side sees every launch; the device side names them (it
    # may miss one near a trace's start, so its counts are not held)
    device, api = kernels_per_call(kernel, reps=3)
    fault = bwd_kernels_fault(device, dtype_name)
    if api != len(BWD_KERNELS) or fault:
        raise SystemExit(f"FAIL {label}: {api} launches a call, {fault}")
    names, by_name = [], {}
    r = {"rel_err": dict(zip(("dq", "dk", "dv"), rel)),
         "max_abs_err": max_abs,
         "bound_rel": BWD_REL[dtype_name],
         "out_max_abs_err": float(out_err.max()),
         "lse_max_abs_err": float(lse_err.max()),
         "device_ms": device_ms(kernel, "flash_attention_bwd_", reps=5,
                                names=names, by_name=by_name),
         "ms": time_ms(kernel, reps=5, batch=2),
         "plain_ms": time_ms(plain, reps=3, batch=1)}
    ok = sdpa_mask(S, window, causal)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=ok,
                                       is_causal=causal and ok is None,
                                       enable_gqa=True)
    do = dout.transpose(1, 2)
    r["library_ms"] = time_ms(
        lambda: torch.autograd.grad(o, (qt, kt, vt), do, retain_graph=True),
        reps=5, batch=2)
    del o, qt, kt, vt
    esize = q.element_size()
    r["bound_ms"], r["bound_by"] = attn_bound(
        10 * B * H * visible_pairs(S, S, causal, window) * hd,
        esize * (4 * B * S * H * hd + 4 * B * S * K * hd) + 4 * B * H * S,
        dtype_name, rate)
    r["kernels"] = names
    # the D pre-pass, the dK/dV and the dQ kernel apart
    r["device_ms_by_kernel"] = {
        part: sum(ms for name, ms in by_name.items()
                  if f"bwd_{part}_kernel" in name)
        for part in ("dot", "dkdv", "dq")}
    print(f"hold {label}: within {BWD_REL[dtype_name]} of max |plain|, two "
          "calls bit-identical, three kernels a call, " + json.dumps(r),
          flush=True)
    torch.cuda.empty_cache()
    return r


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
    if not (torch.equal(y, y_plain) and torch.equal(s, s_plain)):
        raise SystemExit(f"FAIL {label}: not bit-equal to rwkv_scan_plain "
                         f"(max abs err {err}, within RWKV_REL: {ok})")
    # the chunk states a training forward writes, and its y and end state
    ck, ck_plain = (torch.full((B, H, rs.n_chunks(S), hd, hd), math.nan,
                               device="cuda") for _ in range(2))
    y3, s3 = rs._scan(*ins, state, None, ck)
    rs.rwkv_scan_plain(*ins, state, ckpt=ck_plain)
    torch.cuda.synchronize()
    if not (torch.equal(ck, ck_plain) and torch.equal(y3, y)
            and torch.equal(s3, s)):
        raise SystemExit(f"FAIL {label}: with ckpt, the chunk states are "
                         f"{'' if torch.equal(ck, ck_plain) else 'not '}"
                         "bit-equal to rwkv_scan_plain's, y and the end "
                         f"state {'' if torch.equal(y3, y) else 'not '}"
                         "those without it")
    bound_ms, bound_by = rwkv_bound(B, S, H, hd, y.element_size(),
                                    with_state, dtype_name, rate)
    r = {"max_abs_err": err, "exact": True,
         "column_split": rs.column_split(B, H, hd),
         "max_abs_y_plain": float(y_plain.float().abs().max()),
         "rel": RWKV_REL,
         "ms": time_ms(lambda: rs.rwkv_scan(*ins, state)),
         "device_ms": device_ms(lambda: rs.rwkv_scan(*ins, state),
                                "rwkv_scan_kernel"),
         "plain_ms": time_ms(lambda: rs.rwkv_scan_plain(*ins, state), reps=3,
                             batch=1),
         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"hold {label}: bit-equal, in place = out of place, chunk "
          "states bit-equal, " + json.dumps(r), flush=True)
    return r


def rwkv_bwd_bound(B, S, H, hd, with_state, rate):
    """(bound_ms, bound_by) of one backward: r, k, v, w, dy read and dr,
    dk, dv, dw written once, the chunk states read, the end state's
    cotangent (if given) read and d state_0 written; ``RWKV_BWD_OPS`` hd^2
    f32 operations a step and (batch, head)."""
    state = 4 * B * H * hd * hd
    nbytes = (9 * 4 * B * S * H * hd
              + state * (-(-S // 64) + (2 if with_state else 1)))
    return attn_bound(RWKV_BWD_OPS * hd * hd * B * S * H, nbytes, "float32",
                      rate)


def hold_rwkv_bwd(B, S, H, hd, with_state, rate):
    """Phase 2j at one shape: ``rwkv_scan_bwd`` against
    ``rwkv_scan_bwd_plain`` on the same card inputs (r, k, v, w, the chunk
    states of the forward kernel, a random dy and, ``with_state``, a
    random end-state cotangent), all five outputs bit for bit; two calls
    bit-identical; one launch a call, the profiler's kernel its
    ``rwkv_scan_bwd_kernel``.  Times: the kernel (device and per call) and
    the plain version; no PyTorch call computes it."""
    import torch
    from repro_torch.kernels import rwkv_scan as rs
    ins, state = rwkv_inputs(B, S, H, hd, torch.float32, S + hd + 7,
                             with_state)
    rng = np.random.default_rng(S + hd + 8)
    dy = torch.from_numpy(rng.standard_normal((B, S, H, hd),
                                              dtype=np.float32)).cuda()
    ds = (torch.from_numpy(rng.standard_normal(
        (B, H, hd, hd), dtype=np.float32)).cuda() if with_state else None)
    ckpt = torch.empty((B, H, rs.n_chunks(S), hd, hd), device="cuda")
    r, k, v, w, u = ins
    rs._scan(r, k, v, w, u, state, None, ckpt)
    start = ("from a random state, nonzero end cotangent" if with_state
             else "from zeros")
    label = f"rwkv_scan_bwd (B, S, H, hd)={(B, S, H, hd)} {start}"
    args = (r, k, v, w, ckpt, dy, ds)
    before = rs.rwkv_scan_bwd.launches
    got, again = rs.rwkv_scan_bwd(*args), rs.rwkv_scan_bwd(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rs.rwkv_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    want_s = time.perf_counter() - t0
    repeat = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                 for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    equal = [exact(a, b) for a, b in zip(got, want)]
    if (rs.rwkv_scan_bwd.launches != before + 2 or not repeat
            or not finite or not all(equal)):
        raise SystemExit(
            f"FAIL {label}: launches {rs.rwkv_scan_bwd.launches - before}, "
            f"repeat bit-identical {repeat}, finite {finite}, bit-equal "
            f"(dr, dk, dv, dw, ds0) {equal}, max abs err "
            f"{max_abs_err(got, want)}")
    err = max_abs_err(got, want)
    del again, want

    def kernel():
        return rs.rwkv_scan_bwd(*args)

    # the runtime side sees every launch; the device side names the kernel
    # (it misses some of this long kernel's launches, or all of them in a
    # trace, so its counts are not held)
    device, api = kernels_per_call(kernel, reps=5)
    if api != 1 or any("rwkv_scan_bwd_kernel" not in name
                       for name in device):
        raise SystemExit(f"FAIL {label}: {api} launches a call, kernels "
                         f"{device}")
    bound_ms, bound_by = rwkv_bwd_bound(B, S, H, hd, with_state, rate)
    split = rs.bwd_split(B, H, hd)
    r = {"max_abs_err": err, "exact": True, "repeat_bit_identical": True,
         "split": split, "ctas": B * H * split, "kernels_per_call": device,
         "ms": time_ms(kernel, reps=5, batch=2),
         "device_ms": device_ms(kernel, "rwkv_scan_bwd_kernel", reps=5),
         "plain_ms": (want_s * 1e3 if want_s > SLOW_S else time_ms(
             lambda: rs.rwkv_scan_bwd_plain(*args), reps=3, batch=1)),
         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"hold {label}: bit-equal, repeat bit-identical, one kernel a "
          "call, " + json.dumps(r), flush=True)
    del got, args, ckpt
    torch.cuda.empty_cache()
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


def routing_bwd_inputs(T, D, E, dtype, seed, case="random", device="cuda"):
    """``routing_inputs`` and the gates' cotangent dg [T, E] f32 (standard
    normal) from the next numpy seed."""
    import torch
    x, w = routing_inputs(T, D, E, dtype, seed, case, device)
    dg = np.random.default_rng(seed + 1).standard_normal((T, E),
                                                         dtype=np.float32)
    return x, w, torch.from_numpy(dg).to(device)


def hold_routing_bwd(T, D, E, top_k, case, dtype_name, rate):
    """``moe_routing_bwd`` against ``moe_routing_bwd_plain`` on the same
    card inputs, dx and dW bit for bit, two calls bit-identical, its
    launches a call (the token and dW kernels, and the merge where T >
    ``DW_CHUNK``: the runtime's launches and the profiler's names), and the
    times: per call, on the device (its kernels, each one's too) and the
    plain version's; no one PyTorch call computes the function.  The
    bound: 3 x 2 T D E f32 operations (the logits again, dx, dW) or the
    bytes."""
    import torch
    from repro_torch.kernels import moe_routing as mr
    x, w, dg = routing_bwd_inputs(T, D, E, getattr(torch, dtype_name),
                                  T + D + E, case)
    label = (f"moe_routing_bwd (T, D, E, k)={(T, D, E, top_k)} {case} "
             f"x {dtype_name}")
    before = mr.moe_routing_bwd.launches
    dx, dw = mr.moe_routing_bwd(x, w, top_k, dg)
    dx2, dw2 = mr.moe_routing_bwd(x, w, top_k, dg)
    torch.cuda.synchronize()
    pdx, pdw = mr.moe_routing_bwd_plain(x, w, top_k, dg)
    repeat = (torch.equal(dx.view(torch.uint8), dx2.view(torch.uint8))
              and torch.equal(dw.view(torch.uint8), dw2.view(torch.uint8)))
    finite = bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dw).all())
    if (mr.moe_routing_bwd.launches != before + 2 or not repeat
            or not finite or not (exact(dx, pdx) and exact(dw, pdw))):
        raise SystemExit(
            f"FAIL {label}: launches {mr.moe_routing_bwd.launches - before}, "
            f"repeat bit-identical {repeat}, finite {finite}, max abs err "
            f"dx {float((dx.float() - pdx.float()).abs().max())} dW "
            f"{float((dw - pdw).abs().max())}")
    want = 3 if T > mr.DW_CHUNK else 2
    device, api = kernels_per_call(lambda: mr.moe_routing_bwd(x, w, top_k,
                                                              dg), reps=5)
    if api != want or any("moe_routing_bwd_" not in name for name in device):
        raise SystemExit(f"FAIL {label}: {api} launches a call (the design "
                         f"makes {want}), kernels {device}")
    # x, W and dg read, dx and dW written, once each
    nbytes = 2 * T * D * x.element_size() + 2 * D * E * 4 + T * E * 4
    bound_ms, bound_by = attn_bound(6 * T * D * E, nbytes, "float32", rate)
    by_kernel = {}
    r = {"max_abs_err": max_abs_err((dx, dw), (pdx, pdw)), "exact": True,
         "repeat_bit_identical": True, "kernels_per_call": device,
         "ms": time_ms(lambda: mr.moe_routing_bwd(x, w, top_k, dg)),
         "device_ms": device_ms(lambda: mr.moe_routing_bwd(x, w, top_k, dg),
                                "moe_routing_bwd_", by_name=by_kernel),
         "plain_ms": time_ms(lambda: mr.moe_routing_bwd_plain(x, w, top_k,
                                                              dg),
                             reps=3, batch=1),
         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
         "device_ms_by_kernel": by_kernel}
    print(f"hold {label}: bit-equal, repeat bit-identical, "
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


def as_batch(prompt):
    """A request's prefill batch: {"tokens": prompt}, or the prompt itself
    where it is already a batch (a VLM's, with its ``vision_embeds``)."""
    return prompt if isinstance(prompt, dict) else {"tokens": prompt}


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
        out = eng.generate(as_batch(toks), GEN)
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
                          sampler=record).generate(as_batch(toks), GEN)
    return torch.stack(steps), out


def plain_run(model, params, toks, plains):
    """``traced_generate`` with ``plains`` patched in (the names the model
    looks the kernels up by, to their plain versions)."""
    with patched(plains):
        return traced_generate(model, params, toks)


def held_steps(run, ref, bound):
    """``run`` = (logits [T, B, V], tokens [B, T]) held step by step to
    ``ref``: max |delta| / max |ref| of each row's logits within ``bound``;
    a row is compared up to its first parting of tokens, and a parting is
    explained only where the reference's top-2 gap is no larger than max
    |delta logit| at that step."""
    (logits_k, toks_k), (logits_p, toks_p) = run, ref
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
    return {"rows": B, "steps": T, "equal_tokens": equal, "bound": bound,
            "worst_rel_delta": worst, "partings": partings,
            "over_bound": over}


def checked_plain_run(model, params, toks, wrappers, plains):
    """``plain_run``, failing if it launched one of ``wrappers``' kernels."""
    counts = launch_counts(wrappers)
    run = plain_run(model, params, toks, plains)
    if launch_counts(wrappers) != counts:
        raise SystemExit("FAIL parity: the plain run launched a kernel")
    return run


def parity(model, params, toks, dtype_name, wrappers, plains, floor=None,
           ref=None):
    """The same prompts through the kernels and through their plain
    versions (``plains``: the names the model looks up, patched to the
    plain versions), held by ``held_steps`` within ``LOGIT_BOUND``, or
    within ``floor`` where one is given and larger (the plain bf16 run's
    own distance from the f32 function, ``bf16_floor``).  ``wrappers``: the
    kernels whose launch counts show which run is which.  ``ref``: the
    plain run of these prompts where it was made already
    (``checked_plain_run``)."""
    counts = launch_counts(wrappers)
    run_k = traced_generate(model, params, toks)
    if launch_counts(wrappers) == counts:
        raise SystemExit("FAIL parity: the kernel run launched no kernel")
    run_p = ref if ref is not None else checked_plain_run(
        model, params, toks, wrappers, plains)
    bound = LOGIT_BOUND[dtype_name]
    if floor is not None:
        bound = max(bound, floor)
    line = {"arch": model.cfg.name, "dtype": dtype_name,
            **held_steps(run_k, run_p, bound)}
    if floor is not None:
        line.update(logit_bound=LOGIT_BOUND[dtype_name], floor=floor)
    print("parity " + json.dumps(line), flush=True)
    if line["over_bound"] or any(not p["explained"]
                                 for p in line["partings"]):
        raise SystemExit(f"FAIL parity {model.cfg.name} {dtype_name}: "
                         f"{len(line['over_bound'])} steps over the bound or "
                         "an unexplained parting")
    return line


def bf16_floor(name, run16, run32):
    """How far the plain bf16 run itself is from the function: the plain
    versions' bf16 run ``run16`` held by ``held_steps`` to their f32 run
    ``run32`` (the same weights cast, TF32 off) on the same prompts, its
    worst max |delta| / max |f32| up to each row's first parting."""
    line = held_steps(run16, run32, LOGIT_BOUND["bfloat16"])
    print("bf16_floor " + json.dumps({"arch": name, **line}), flush=True)
    return line["worst_rel_delta"]


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
    from repro_torch.kernels import moe_routing as mr
    runs = {}
    for side, route in (("kernel", mr.moe_routing),
                        ("plain", mr.moe_routing_plain)):
        counts = launch_counts(wrappers)
        runs[side] = routed_generate(model, params, toks, route,
                                     plains if side == "plain" else {})
        launched = {k: n - counts[k] for k, n in launch_counts(wrappers).items()}
        if side == "kernel" and not all(launched.values()):
            raise SystemExit(f"FAIL moe parity: the kernel run launched "
                             f"{launched}")
        if side == "plain" and any(launched.values()):
            raise SystemExit(f"FAIL moe parity: the plain run launched "
                             f"{launched}")
    return held_moe_runs("moe_parity", model, dtype_name, runs["kernel"],
                         runs["plain"])


def routed_generate(model, params, toks, route, patches):
    """``traced_generate`` with the router ``route`` (its kernel or plain
    version) recording every call's mask and probabilities, and the names
    of ``patches`` patched: (logits, tokens, routing log)."""
    log = []
    with patched(patches) as stack:
        stack.enter_context(mock.patch("repro_torch.models.layers.moe_routing",
                                       routing_recorder(route, log)))
        logits, out = traced_generate(model, params, toks)
    return logits, out, log


def held_moe_runs(tag, model, dtype_name, run_k, run_p):
    """Two ``routed_generate`` runs held by ``moe_parity``'s rule, the
    second (``run_p``) the reference; prints one ``tag`` line."""
    (logits_k, toks_k, log_k), (logits_p, toks_p, log_p) = run_k, run_p
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
    print(f"{tag} " + json.dumps(line), flush=True)
    if (any(not o["explained"] for o in over)
            or any(not p["explained"] for p in partings)):
        raise SystemExit(f"FAIL {tag} {dtype_name}: a step over the "
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
            or ("flash_attention" in wrappers and not line[
                "plain_router_run_launches"]["flash_attention"])):
        raise SystemExit("FAIL routing parity: the router's kernel and its "
                         "plain version part on the served path")
    return line


def absorbed(model):
    """``model`` with its decode on the absorbed MLA path."""
    import functools
    return dataclasses.replace(
        model, decode=functools.partial(model.decode, absorb_mla=True))


def absorb_parity(model, params, toks):
    """The absorbed MLA decode (``absorb_mla=True``: wk_b folded into q,
    wv_b into the output, attention in the rank-R latent space as MQA)
    against the expanded decode of the engine's default path, the same
    prompts and prefill.  The JAX layer divides the absorbed scores by
    sqrt(R + rope) (576), the expanded ones by sqrt(nope + rope) (192): at
    their own scales the two modes are different functions, and that
    difference is printed.  Held to ``LOGIT_BOUND`` by ``moe_parity``'s
    rule (a step over it, or a parting of tokens, explained by a near-tie
    routing flip) is the expanded decode with its decode queries scaled by
    sqrt(192 / 576), the absorbed mode's softmax, contracted in the other
    order (the scaled queries kept in f32, where the attention computes);
    the router's kernel runs in all three runs."""
    import torch
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.models import common
    m = model.cfg.mla
    ratio = math.sqrt((m.qk_nope_head_dim + m.qk_rope_head_dim)
                      / (m.kv_lora_rank + m.qk_rope_head_dim))

    def scaled(cfg, q, k, v, **kw):
        if q.shape[1] != 1 or kw.get("k_valid") is None:
            return common.attention(cfg, q, k, v, **kw)
        return common.attention(cfg, q.float() * ratio, k.float(), v.float(),
                                **kw).to(q.dtype)

    run_a = routed_generate(absorbed(model), params, toks, mr.moe_routing,
                            {})
    logits_a, toks_a, _ = run_a
    logits_e, toks_e, _ = routed_generate(model, params, toks,
                                          mr.moe_routing, {})
    run_s = routed_generate(model, params, toks, mr.moe_routing,
                            {"repro_torch.models.layers.attention": scaled})
    own = (logits_a - logits_e).abs().amax(-1) / logits_e.abs().amax(-1)
    print("absorb_scales " + json.dumps({
        "arch": model.cfg.name, "score_scale_absorbed": 1 / math.sqrt(
            m.kv_lora_rank + m.qk_rope_head_dim),
        "score_scale_expanded": 1 / math.sqrt(m.qk_nope_head_dim
                                              + m.qk_rope_head_dim),
        "prefill_logits_equal": torch.equal(logits_a[0], logits_e[0]),
        "worst_rel_delta_at_own_scales": float(own.max()),
        "equal_tokens_at_own_scales": int((toks_a == toks_e).sum())}),
        flush=True)
    if not torch.equal(logits_a[0], logits_e[0]):
        raise SystemExit("FAIL absorb parity: the two modes' prefills differ")
    return held_moe_runs("absorb_parity", model, model.cfg.dtype, run_a,
                         run_s)


def first_layers(params, cfg, n):
    """A clone of the embeddings and the first ``n`` layers of ``params``:
    the groups of ``cfg`` cut to ``n`` layers, each a prefix of the full
    layout's group of the same kind."""
    from repro_torch._tree import tree_map
    from repro_torch.models.decoder import build_layout
    full = build_layout(cfg)
    groups = []
    for g, f, gp in zip(build_layout(dataclasses.replace(cfg, n_layers=n)),
                        full, params["groups"]):
        if g.spec != f.spec or g.n > f.n:
            raise SystemExit(f"FAIL first_layers: {g} is not a prefix of {f}")
        groups.append(tree_map(lambda t, k=g.n: t[:k].clone(), gp))
    return {"embed": tree_map(lambda t: t.clone(), params["embed"]),
            "groups": groups}


def set_gates(params, cfg, value):
    """Every cross layer's ``gate_attn`` and ``gate_ffn`` set to ``value``
    (the init's 0 would multiply the whole cross-attention path by
    tanh(0) = 0); returns the number of cross layers."""
    from repro_torch.models.decoder import build_layout
    n = 0
    for g, gp in zip(build_layout(cfg), params["groups"]):
        if g.spec.kind == "cross":
            gp["attn"]["gate_attn"].fill_(value)
            gp["attn"]["gate_ffn"].fill_(value)
            n += g.n
    return n


def decode_profile(model, params, toks, share=("decode_attention_share",
                                               "decode_attention_"), steps=4,
                   mode=None):
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
    batch = as_batch(toks)
    B, S = batch["tokens"].shape
    logits, caches = model.prefill(params, batch)
    ctx_len = (batch["audio_embeds"].shape[1] if "audio_embeds" in batch
               else None)
    caches = pad_cache(caches, model.init_cache(B, PROMPT + GEN + 8,
                                                ctx_len))
    state = {"tok": greedy(logits), "pos": S, "caches": caches}

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
            **({"mode": mode} if mode else {}),
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


def kernel_wrappers():
    """The model kernels' wrappers by name (each counts its launches)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import rwkv_scan as rs
    return {"flash_attention": fa.flash_attention,
            "decode_attention": da.decode_attention,
            "moe_routing": mr.moe_routing, "rwkv_scan": rs.rwkv_scan}


def serve_mla(dcfg, f32_layers, full_layers, device=None):
    """Phase 4d on ``dcfg`` (deepseek-v2 at full width, its depth cut): the
    serving run, its launches held to the router's alone; parity (i) the
    router alone, bit for bit, (iii) bf16 on all layers, (ii) f32 on the
    first ``f32_layers``; the absorbed decode against the expanded one
    (``absorb_parity``) in bf16 on all layers and in f32 on the first;
    decode-step profiles of both modes.  ``device``: the card unless the
    CPU is asked for (a rehearsal at a reduced size).  Returns (launches,
    the expanded and the absorbed profile)."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models.registry import build_model
    wrappers = kernel_wrappers()
    dmodel = build_model(dcfg, device=device)
    t0 = time.perf_counter()
    params = dmodel.init_params(torch.Generator(device=dmodel.device)
                                .manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    L = dcfg.n_layers
    per_layer = sum(t.numel() for t in tree_leaves(params["groups"])) / L
    m, e = dcfg.mla, dcfg.moe
    print(f"params: {dcfg.name} {dcfg.dtype}, {L} of {full_layers} layers x "
          f"d_model {dcfg.d_model}, {dcfg.n_heads} heads, MLA ranks "
          f"{m.q_lora_rank} / {m.kv_lora_rank}, qk {m.qk_nope_head_dim} + "
          f"{m.qk_rope_head_dim}, v {m.v_head_dim}, {e.n_experts} routed + "
          f"{e.n_shared} shared experts of {e.d_ff_expert} top-{e.top_k}, "
          f"{n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s; depth cut to {L}: a layer "
          f"holds {per_layer / 1e9:.3f} B parameters "
          f"({2 * per_layer / 1e9:.2f} GB in bf16), so all {full_layers} do "
          "not fit the card's 80 GB, and one more would leave too little for "
          "the prefill's naive attention ([4, 128, 1024, 1024] f32 scores, "
          "2.1 GB, and its softmax)", flush=True)
    rng = torch.Generator(device=dmodel.device).manual_seed(1)
    prompts = [torch.randint(0, dcfg.vocab, (SERVE_BATCH, PROMPT),
                             generator=rng, device=dmodel.device)
               for _ in range(REQUESTS)]
    router = {"moe_routing": wrappers["moe_routing"]}
    none = {k: 0 for k in wrappers if k != "moe_routing"}
    launches = serve_run(
        dmodel, params, prompts, wrappers,
        {"moe_routing": L * REQUESTS, **none},
        {"moe_routing": L * (GEN - 1) * REQUESTS, **none})
    routing_exact_parity(dmodel, params, prompts[0], router)
    moe_parity(dmodel, params, prompts[0], "bfloat16", router, {})
    absorb_parity(dmodel, params, prompts[0])
    share = ("moe_routing_share", "moe_routing_kernel")
    profiles = (decode_profile(dmodel, params, prompts[0], share=share,
                               mode="expanded"),
                decode_profile(absorbed(dmodel), params, prompts[0],
                               share=share, mode="absorb_mla"))
    # the f32 parity on the first layers: cloned in bf16, the served params
    # freed, and only then cast, so the card never holds both
    first = first_layers(params, dcfg, f32_layers)
    del params
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.float(), first)
    del first
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(
        dcfg, n_layers=f32_layers, dtype="float32"), device=dmodel.device)
    moe_parity(model32, params, prompts[0], "float32", router, {})
    absorb_parity(model32, params, prompts[0])
    del params, prompts
    torch.cuda.empty_cache()
    return (launches,) + profiles


def serve_vlm(vcfg, f32_layers, device=None):
    """Phase 4e on ``vcfg`` (llama-3.2-vision at full width): every cross
    layer's gates set to ``VLM_GATE``, the serving run with its
    ``vision_embeds``, its launches held to flash in prefill and decode
    attention in decode on the self layers alone; parity in bf16 on all
    layers and in f32 on the first ``f32_layers``; a decode-step profile.
    ``device`` as in ``serve_mla``.  Returns (launches, profile)."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.launch.serve import vision_embeds
    from repro_torch.models.registry import build_model
    wrappers = kernel_wrappers()
    attn = {k: wrappers[k] for k in ("flash_attention", "decode_attention")}
    attn_plains = attention_plains()
    vmodel = build_model(vcfg, device=device)
    t0 = time.perf_counter()
    params = vmodel.init_params(torch.Generator(device=vmodel.device)
                                .manual_seed(0))
    n_cross = set_gates(params, vcfg, VLM_GATE)
    torch.cuda.synchronize()
    n_self = vcfg.n_layers - n_cross
    print(f"params: {vcfg.name} {vcfg.dtype}, {vcfg.n_layers} layers "
          f"({n_self} self-attention, {n_cross} cross-attention) x d_model "
          f"{vcfg.d_model}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s; every cross "
          f"layer's gate_attn and gate_ffn set to {VLM_GATE} (the init's 0 "
          "would multiply the cross-attention path by tanh(0) = 0)",
          flush=True)
    rng = torch.Generator(device=vmodel.device).manual_seed(1)
    prompts = [{"tokens": torch.randint(0, vcfg.vocab, (SERVE_BATCH, PROMPT),
                                        generator=rng, device=vmodel.device),
                "vision_embeds": vision_embeds(vcfg, SERVE_BATCH, rng,
                                               vmodel.device)}
               for _ in range(REQUESTS)]
    none = {"moe_routing": 0, "rwkv_scan": 0}
    launches = serve_run(
        vmodel, params, prompts, wrappers,
        {"flash_attention": n_self * REQUESTS, "decode_attention": 0, **none},
        {"flash_attention": 0,
         "decode_attention": n_self * (GEN - 1) * REQUESTS, **none})
    parity(vmodel, params, prompts[0], "bfloat16", attn, attn_plains)
    profile = decode_profile(vmodel, params, prompts[0])
    first = first_layers(params, vcfg, f32_layers)
    del params
    torch.cuda.empty_cache()
    params = tree_map(lambda t: t.float(), first)
    del first
    torch.cuda.empty_cache()
    parity(build_model(dataclasses.replace(
        vcfg, n_layers=f32_layers, dtype="float32"), device=vmodel.device),
        params, tree_map(lambda t: t.float() if t.is_floating_point() else t,
                         prompts[0]), "float32", attn, attn_plains)
    del params, prompts
    torch.cuda.empty_cache()
    return launches, profile


def attention_plains():
    """The attention kernels' plain versions, under the names the model
    looks them up by."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    return {"repro_torch.models.common.flash_attention":
            fa.flash_attention_plain,
            "repro_torch.models.common.decode_attention":
            da.decode_attention_plain}


def prefill_profile(model, params, toks, share=("mamba_recurrence_share",
                                                "addcmul")):
    """One prefill of ``toks``: its host seconds (the device synchronised
    at both ends), then a profile of the device's activity alone over one
    more: device ms, the share of the kernels whose names contain
    ``share[1]`` (the Mamba recurrence's in-place ``addcmul_``, one launch
    a token and layer), kernels a prefill and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = as_batch(toks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.prefill(params, batch)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # the device's activity alone: a prefill is tens of thousands of ops;
    # (a rehearsal on a machine without a card records the host's)
    with profile(activities=[ProfilerActivity.CUDA
                             if torch.cuda.is_available()
                             else ProfilerActivity.CPU]) as prof:
        model.prefill(params, batch)
        torch.cuda.synchronize()
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            n += 1
    device = sum(by_name.values())
    part = sum(v for k, v in by_name.items() if share[1] in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    line = {"arch": model.cfg.name, "host_s": host_s,
            "device_ms": device if by_name else None,
            "idle_share": (1.0 - device / (host_s * 1e3) if by_name
                           else None),
            share[0]: part / device if device else None,
            "kernels": n, "top_kernels_ms": [[k[:90], v] for k, v in top]}
    print("prefill_profile " + json.dumps(line), flush=True)
    return line


def serve_hymba(hcfg, device=None):
    """Phase 4f on ``hcfg`` (hymba-1.5b at full width): the serving run,
    its launches held to flash in prefill and decode attention in decode
    on every layer, windowed or global, and to nothing else; parity in bf16
    and in f32 on all layers; a decode-step profile and a prefill profile
    with the Mamba recurrence's share.  The random-weight hymba's own bf16
    noise (the plain bf16 run against the plain f32 run, ``bf16_floor``)
    is above ``LOGIT_BOUND``'s 3e-2 (0.036 on the H100), so its bf16
    parity is held within that floor where it is larger; the f32 parity
    keeps 1e-4.  ``device`` as in ``serve_mla``.  Returns (launches,
    decode profile, prefill profile)."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models.decoder import build_layout
    from repro_torch.models.registry import build_model
    wrappers = kernel_wrappers()
    attn = {k: wrappers[k] for k in ("flash_attention", "decode_attention")}
    hmodel = build_model(hcfg, device=device)
    t0 = time.perf_counter()
    params = hmodel.init_params(torch.Generator(device=hmodel.device)
                                .manual_seed(0))
    torch.cuda.synchronize()
    windowed = sum(g.n for g in build_layout(hcfg) if g.spec.window)
    s = hcfg.ssm
    print(f"params: {hcfg.name} {hcfg.dtype}, {hcfg.n_layers} layers "
          f"({hcfg.n_layers - windowed} global, {windowed} windowed at "
          f"{hcfg.sliding_window}) x d_model {hcfg.d_model}, {hcfg.n_heads} "
          f"query over {hcfg.n_kv_heads} kv heads, Mamba d_inner "
          f"{s.d_inner_mult * hcfg.d_model} state {s.state_dim}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator(device=hmodel.device).manual_seed(1)
    prompts = [torch.randint(0, hcfg.vocab, (SERVE_BATCH, PROMPT),
                             generator=rng, device=hmodel.device)
               for _ in range(REQUESTS)]
    L = hcfg.n_layers
    none = {"moe_routing": 0, "rwkv_scan": 0}
    launches = serve_run(
        hmodel, params, prompts, wrappers,
        {"flash_attention": L * REQUESTS, "decode_attention": 0, **none},
        {"flash_attention": 0, "decode_attention": L * (GEN - 1) * REQUESTS,
         **none})
    model32 = build_model(dataclasses.replace(hcfg, dtype="float32"),
                          device=hmodel.device)
    params32 = tree_map(lambda t: t.float(), params)  # A_log is f32 already
    # each plain run made once: the floor's and the parity holds' reference
    plain16, plain32 = (checked_plain_run(m, p, prompts[0], attn,
                                          attention_plains())
                        for m, p in ((hmodel, params), (model32, params32)))
    floor = bf16_floor(hcfg.name, plain16, plain32)
    parity(hmodel, params, prompts[0], "bfloat16", attn, attention_plains(),
           floor=floor, ref=plain16)
    profile = decode_profile(hmodel, params, prompts[0])
    prefill = prefill_profile(hmodel, params, prompts[0])
    del params
    torch.cuda.empty_cache()
    parity(model32, params32, prompts[0], "float32", attn,
           attention_plains(), ref=plain32)
    del params32, prompts
    torch.cuda.empty_cache()
    return launches, profile, prefill


def serve_encdec(ecfg, device=None):
    """Phase 4g on ``ecfg`` (seamless-m4t-medium at full width): the
    serving run with ``audio_embeds`` of the prompt's length, its launches
    held to flash in prefill (the encoder's and the cross layers'
    non-causal, the self layers' causal, counted apart) and decode attention
    in decode on the self layers alone; parity in bf16 and in f32 on all
    layers; a decode-step profile.  ``device`` as in ``serve_mla``.
    Returns (launches, profile)."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.launch.serve import audio_embeds
    from repro_torch.models import common
    from repro_torch.models.registry import build_model
    wrappers = kernel_wrappers()
    attn = {k: wrappers[k] for k in ("flash_attention", "decode_attention")}
    emodel = build_model(ecfg, device=device)
    t0 = time.perf_counter()
    params = emodel.init_params(torch.Generator(device=emodel.device)
                                .manual_seed(0))
    torch.cuda.synchronize()
    E, L = ecfg.encdec.n_enc_layers, ecfg.n_layers
    print(f"params: {ecfg.name} {ecfg.dtype}, {E} encoder + {L} decoder "
          f"layers x d_model {ecfg.d_model}, vocab {ecfg.vocab}, "
          f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator(device=emodel.device).manual_seed(1)
    prompts = [{"tokens": torch.randint(0, ecfg.vocab, (SERVE_BATCH, PROMPT),
                                        generator=rng, device=emodel.device),
                "audio_embeds": audio_embeds(ecfg, SERVE_BATCH, PROMPT, rng,
                                             emodel.device)}
               for _ in range(REQUESTS)]
    # the flash calls by mask, beside the wrapper's launch count
    masks = {"causal": 0, "non_causal": 0}
    flash = common.flash_attention

    def by_mask(q, k, v, *, causal=True, window=None):
        masks["causal" if causal else "non_causal"] += 1
        return flash(q, k, v, causal=causal, window=window)

    none = {"moe_routing": 0, "rwkv_scan": 0}
    with mock.patch.object(common, "flash_attention", by_mask):
        launches = serve_run(
            emodel, params, prompts, wrappers,
            {"flash_attention": (E + 2 * L) * REQUESTS,
             "decode_attention": 0, **none},
            {"flash_attention": 0,
             "decode_attention": L * (GEN - 1) * REQUESTS, **none})
    want = {"causal": L * REQUESTS, "non_causal": (E + L) * REQUESTS}
    print("flash_masks " + json.dumps({"arch": ecfg.name, "calls": masks,
                                       "expected": want}), flush=True)
    if masks != want:
        raise SystemExit(f"FAIL serve {ecfg.name}: flash calls {masks}, "
                         f"expected {want}")
    parity(emodel, params, prompts[0], "bfloat16", attn, attention_plains())
    profile = decode_profile(emodel, params, prompts[0])
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    parity(build_model(dataclasses.replace(ecfg, dtype="float32"),
                       device=emodel.device),
           params, tree_map(lambda t: t.float() if t.is_floating_point()
                            else t, prompts[0]), "float32", attn,
           attention_plains())
    del params, prompts
    torch.cuda.empty_cache()
    return launches, profile


def train_wrappers():
    """The kernel wrappers a training step is counted by: the flash,
    router and WKV forwards and backwards, and decode attention, which
    must not launch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import rwkv_scan as rs
    return dict(kernel_wrappers(), flash_attention_bwd=fa.flash_attention_bwd,
                moe_routing_bwd=mr.moe_routing_bwd,
                rwkv_scan_bwd=rs.rwkv_scan_bwd)


def plain_launch_forward(q, k, v, causal, window, with_lse):
    """``flash_attention_plain`` in the place of the forward kernel's
    launch: (out, lse or None), launching nothing."""
    from repro_torch.kernels import flash_attention as fa
    if with_lse:
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                        return_lse=True)
    return fa.flash_attention_plain(q, k, v, causal=causal,
                                    window=window), None


def plain_launch_routing(x, router_w, top_k, design):
    """``moe_routing_plain`` in the place of the router kernel's launch."""
    from repro_torch.kernels import moe_routing as mr
    return mr.moe_routing_plain(x, router_w, top_k)


def plain_launch_rwkv(r, k, v, w, u, state, state_out, ckpt):
    """``rwkv_scan_plain`` in the place of the WKV kernel's launch."""
    from repro_torch.kernels import rwkv_scan as rs
    return rs.rwkv_scan_plain(r, k, v, w, u, state, state_out=state_out,
                              ckpt=ckpt)


def attention_plain_grad():
    """The flash, router and WKV kernels' plain versions, forward and
    backward, in the places where ``flash_attention``, ``moe_routing``,
    ``rwkv_scan`` and their autograd Functions launch them: the same wiring
    (saved tensors, masks, chunk states, casts) on the plain versions."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import rwkv_scan as rs
    return {"repro_torch.kernels.flash_attention._launch_forward":
            plain_launch_forward,
            "repro_torch.kernels.flash_attention.flash_attention_bwd":
            fa.flash_attention_bwd_plain,
            "repro_torch.kernels.moe_routing._launch": plain_launch_routing,
            "repro_torch.kernels.moe_routing.moe_routing_bwd":
            mr.moe_routing_bwd_plain,
            "repro_torch.kernels.rwkv_scan._launch": plain_launch_rwkv,
            "repro_torch.kernels.rwkv_scan.rwkv_scan_bwd":
            rs.rwkv_scan_bwd_plain}


def train_plains():
    """The forward kernels' plain versions for a loss without a gradient:
    the attention's, the router's and the WKV scan's, under the names the
    model looks them up by."""
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import rwkv_scan as rs
    return dict(attention_plains(), **{
        "repro_torch.models.layers.moe_routing": mr.moe_routing_plain,
        "repro_torch.models.layers.rwkv_scan": rs.rwkv_scan_plain})


def patched(patches):
    """Each name of ``patches`` patched to its value (a kernel's plain
    version, a recorder), as one context; the patches are entered at
    once."""
    stack = ExitStack()
    for target, value in patches.items():
        stack.enter_context(mock.patch(target, value))
    return stack


def train_batches(cfg, B, S, n, device):
    """``n`` batches of the launcher's ``DataLoader`` copy (seed 0) and its
    frontend stubs, on ``device`` in the model's dtype."""
    from repro_torch.launch.train import extra_fn_of, to_device
    from repro_torch.training.data import DataLoader
    dl = DataLoader(cfg.vocab, B, S, seed=0, extra_fn=extra_fn_of(cfg))
    try:
        return [to_device(next(dl), cfg, device) for _ in range(n)]
    finally:
        dl.close()


def mask_counts():
    """Recorders of the flash calls by mask: the forward's (on the name the
    model looks it up by) and the backward's (``FlashAttentionFn``'s), and
    their counts."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common
    counts = {"forward": {"causal": 0, "non_causal": 0},
              "backward": {"causal": 0, "non_causal": 0}}
    flash, backward = common.flash_attention, fa.FlashAttentionFn.backward

    def fwd(q, k, v, *, causal=True, window=None):
        counts["forward"]["causal" if causal else "non_causal"] += 1
        return flash(q, k, v, causal=causal, window=window)

    def bwd(ctx, dout):
        counts["backward"]["causal" if ctx.causal else "non_causal"] += 1
        return backward(ctx, dout)

    stack = ExitStack()
    stack.enter_context(mock.patch.object(common, "flash_attention", fwd))
    stack.enter_context(mock.patch.object(fa.FlashAttentionFn, "backward",
                                          staticmethod(bwd)))
    return stack, counts


def device_split(prof):
    """Device ms of a profiled window by kind of kernel, from its names."""
    from torch.autograd import DeviceType
    split = {"flash_forward": 0.0, "flash_backward": 0.0,
             "router_forward": 0.0, "router_backward": 0.0,
             "wkv_forward": 0.0, "wkv_backward": 0.0, "gemm": 0.0,
             "mamba_recurrence": 0.0, "elementwise": 0.0, "reduce": 0.0,
             "other": 0.0}
    n = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name, ms = e.name.lower(), e.time_range.elapsed_us() / 1e3
        n += 1
        if "rwkv_scan_bwd_kernel" in name:
            split["wkv_backward"] += ms
        elif "rwkv_scan_kernel" in name:
            split["wkv_forward"] += ms
        elif "moe_routing_bwd_" in name:
            split["router_backward"] += ms
        elif "moe_routing_kernel" in name:
            split["router_forward"] += ms
        elif "flash_attention_bwd_" in name:
            split["flash_backward"] += ms
        elif "flash_attention_kernel" in name:
            split["flash_forward"] += ms
        elif any(k in name for k in ("gemm", "cutlass", "xmma", "cublas",
                                     "sm90_", "nvjet")):
            split["gemm"] += ms
        elif "addcmul" in name:     # MambaRecurrence, a step a launch
            split["mamba_recurrence"] += ms
        elif "elementwise" in name or "vectorized" in name:
            split["elementwise"] += ms
        elif "reduce" in name or "softmax" in name or "logsumexp" in name:
            split["reduce"] += ms
        else:
            split["other"] += ms
    return split, n


def profiled_step(model, state, batch, opt_cfg):
    """One training step in two profiled windows, the loss and its
    gradient, then the optimizer, each synchronised: host seconds, device
    ms by kind, the optimizer's device ms, kernels, idle share, the Mamba
    recurrence's share of the device time; and the loss chunks alone
    (``chunked_ce_loss``, forward and backward, on the stack's output),
    whose kernels are also among the first window's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import common, decoder
    from repro_torch.models.registry import chunked_ce_loss
    from repro_torch.training.optimizer import adamw_update
    from repro_torch.training.train_step import loss_and_grads
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof_grad:
        loss, grads = loss_and_grads(model, state["params"], batch)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    with profile(activities=acts) as prof_opt:
        adamw_update(opt_cfg, state["params"], grads, state["opt"])
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    split, n_grad = device_split(prof_grad)
    opt_split, n_opt = device_split(prof_opt)
    optimizer_ms = sum(opt_split.values())
    # the loss chunks alone, on the stack's output for this batch
    params = state["params"]
    cfg = model.cfg
    with torch.no_grad():
        ctx = (decoder.encoder_stack(params["encoder"], cfg,
                                     batch["audio_embeds"])
               if cfg.encdec else batch.get("vision_embeds"))
        x = common.embed(params["embed"], cfg, batch["tokens"])
        x, _ = decoder.decoder_stack(params, cfg, x, mode="train", ctx=ctx)
    x = x.detach().requires_grad_()
    with profile(activities=acts) as prof_loss:
        ce = chunked_ce_loss(params, cfg, x, batch["labels"])
        torch.autograd.grad(ce, x)
        torch.cuda.synchronize()
    del x
    loss_ms = sum(device_split(prof_loss)[0].values())
    device = sum(split.values()) + optimizer_ms
    host_ms = (t2 - t0) * 1e3
    line = {"arch": cfg.name, "layers": cfg.n_layers, "loss": float(loss),
            "host_ms": host_ms, "grad_host_ms": (t1 - t0) * 1e3,
            "optimizer_host_ms": (t2 - t1) * 1e3,
            "device_ms": device if n_grad else None,
            "device_ms_by_kind": split, "optimizer_device_ms": optimizer_ms,
            "loss_chunks_device_ms_alone": loss_ms,
            "kernels": n_grad + n_opt,
            "idle_share": 1.0 - device / host_ms if n_grad else None,
            "mamba_recurrence_share": (split["mamba_recurrence"] / device
                                       if n_grad else None)}
    print("train_profile " + json.dumps(line), flush=True)
    return line


def rel_to_max(a, b):
    """max |a - b| / max |b| in float64 (0 where b is all zeros and a = b)."""
    d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    m = float(b.double().abs().max()) if b.numel() else 0.0
    return d / m if m else (0.0 if d == 0.0 else math.inf)


def held_f32_step(model, params, batch, opt_cfg, wrappers):
    """Hold (ii): one f32 step (TF32 off) on the kernels against the same
    step on the plain versions, from ``params`` (cloned for the kernels):
    the loss within ``TRAIN_F32_REL["loss"]``, every leaf's grad, m and v
    within theirs of the leaf's max |plain|.

    The params after the step.  Adam's first step moves an element by
    lr (u / (|u| + eps) + wd p), u = clip g: about sign(g) lr, and where |u|
    is within a few eps of 0 the sign and size of that step are not set by
    the f32 sums.  So an element may be off the plain one by lr * 1e-3 +
    2 f32 ulps of it, plus lr times the most that u / (|u| + eps) can move
    when u moves by the grad hold's own bound, tau = clip * 1e-4 * max |g|
    of its leaf: at most eps tau / (max(|u| - tau, 0) + eps)^2, and 2 (a
    flipped sign).  Elements over the first part and within the second are
    printed as excused.  Where the card's free memory is under
    ``F32_ROOM`` times the kernels' run (params, grads, m and v: room for
    the plain run's and its activations), that run waits on the host while
    the plain run's are taken, so the card holds one f32 train state at a
    time beside ``params``."""
    import torch
    from repro_torch._tree import tree_leaves, tree_leaves_with_paths, tree_map
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    from repro_torch.training.train_step import loss_and_grads
    runs = {}
    p_dev = tree_leaves(params)[0].device
    kept = "card"       # where the kernels' run waits for the plain run
    for which in ("kernels", "plain"):     # the plain step updates params
        p = tree_map(lambda t: t.clone(), params) if which == "kernels" \
            else params
        state = {"params": p, "opt": init_opt_state(p)}
        before = launch_counts(wrappers)
        if which == "plain":
            with patched(attention_plain_grad()):
                loss, grads = loss_and_grads(model, p, batch)
        else:
            loss, grads = loss_and_grads(model, p, batch)
        torch.cuda.synchronize()
        after = launch_counts(wrappers)
        moved = {k: after[k] - before[k] for k in after}
        if (which == "plain") != (not any(moved.values())):
            raise SystemExit(f"FAIL f32 step {model.cfg.name}: the {which} "
                             f"run launched {moved}")
        _, opt, metrics = adamw_update(opt_cfg, p, grads, state["opt"])
        run = {"grads": grads, "params": p, "opt": opt}
        if which == "kernels" and p_dev.type == "cuda":
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(run))
            if torch.cuda.mem_get_info(p_dev)[0] < F32_ROOM * nbytes:
                run = tree_map(lambda t: t.cpu(), run)
                kept = "host"
        runs[which] = dict(run, loss=float(loss), lr=float(metrics["lr"]),
                           clip=min(1.0, opt_cfg.grad_clip
                                    / max(float(metrics["grad_norm"]),
                                          1e-9)))
        del state, p, grads, opt, run
        torch.cuda.empty_cache()
    k, q = runs["kernels"], runs["plain"]
    lr = q["lr"]
    worst = {"loss": abs(k["loss"] - q["loss"]) / abs(q["loss"]),
             "grad": 0.0, "m": 0.0, "v": 0.0}
    for name, tk, tq in (("grad", k["grads"], q["grads"]),
                         ("m", k["opt"]["m"], q["opt"]["m"]),
                         ("v", k["opt"]["v"], q["opt"]["v"])):
        for (key, a), (_, b) in zip(tree_leaves_with_paths(tk),
                                    tree_leaves_with_paths(tq)):
            worst[name] = max(worst[name], rel_to_max(a.to(b.device), b))
    ulp, eps, clip = torch.finfo(torch.float32).eps, opt_cfg.eps, q["clip"]
    over = excused = elements = 0
    worst_param = 0.0
    for (key, a), (_, b), (_, g) in zip(
            tree_leaves_with_paths(k["params"]),
            tree_leaves_with_paths(q["params"]),
            tree_leaves_with_paths(q["grads"])):
        d = (a.to(b.device).double() - b.double()).abs()
        base = lr * 1e-3 + 2 * ulp * b.double().abs()
        u = clip * g.double().abs()
        tau = TRAIN_F32_REL["grad"] * float(u.max())
        moved = torch.clamp(eps * tau / (torch.clamp(u - tau, min=0.0)
                                         + eps) ** 2, max=2.0)
        far = d > base
        bad = d > base + lr * moved
        over += int(bad.sum())
        excused += int((far & ~bad).sum())
        elements += a.numel()
        worst_param = max(worst_param, float(d.max()) / lr)
    line = {"arch": model.cfg.name, "layers": model.cfg.n_layers,
            "dtype": "float32", "loss_kernels": k["loss"],
            "loss_plain": q["loss"], "rel": worst, "bound": TRAIN_F32_REL,
            "lr": lr, "param_elements": elements,
            "params_over": over, "params_excused_near_zero_u": excused,
            "worst_param_delta_over_lr": worst_param,
            "kernels_run_kept_on": kept}
    print("train_f32_step " + json.dumps(line), flush=True)
    if over or any(worst[key] > TRAIN_F32_REL[key] for key in worst):
        raise SystemExit(f"FAIL f32 step {model.cfg.name}: {line}")
    return line


def held_f32_grads(model, params, batch, wrappers):
    """Hold (ii) where an f32 step's optimizer state does not fit the card:
    the f32 loss and every leaf's grad (TF32 off) on the kernels against
    the plain versions, the loss within ``TRAIN_F32_REL["loss"]`` and each
    grad within ``TRAIN_F32_REL["grad"]`` of its leaf's max |plain|.  The
    kernels' grads wait on the host while the plain run's are taken."""
    import torch
    from repro_torch._tree import tree_leaves_with_paths, tree_map
    from repro_torch.training.train_step import loss_and_grads
    runs = {}
    for which in ("kernels", "plain"):
        before = launch_counts(wrappers)
        with patched(attention_plain_grad() if which == "plain" else {}):
            loss, grads = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        after = launch_counts(wrappers)
        moved = {k: after[k] - before[k] for k in after}
        if (which == "plain") != (not any(moved.values())):
            raise SystemExit(f"FAIL f32 grads {model.cfg.name}: the {which} "
                             f"run launched {moved}")
        if which == "kernels":
            grads = tree_map(lambda t: t.cpu(), grads)
        runs[which] = (float(loss), grads)
    (lk, gk), (lq, gq) = runs["kernels"], runs["plain"]
    worst = {"loss": abs(lk - lq) / abs(lq), "grad": 0.0}
    for (key, a), (_, b) in zip(tree_leaves_with_paths(gk),
                                tree_leaves_with_paths(gq)):
        worst["grad"] = max(worst["grad"], rel_to_max(a.to(b.device), b))
    line = {"arch": model.cfg.name, "layers": model.cfg.n_layers,
            "dtype": "float32", "held": "loss and grads, no optimizer step",
            "loss_kernels": lk, "loss_plain": lq, "rel": worst,
            "bound": {k: TRAIN_F32_REL[k] for k in worst}}
    print("train_f32_grads " + json.dumps(line), flush=True)
    if any(worst[k] > TRAIN_F32_REL[k] for k in worst):
        raise SystemExit(f"FAIL f32 grads {model.cfg.name}: {line}")
    return line


def resume_check(arch, device=None):
    """Hold (iii) at the tests' reduced size: three steps straight against
    two steps, a checkpoint, a restore and the third step; every leaf of
    the state and the third step's loss bit-equal."""
    import tempfile
    import torch
    from repro_torch._tree import tree_leaves_with_paths
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device=device)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=20)
    step_fn = make_train_step(model, opt_cfg)
    bs = train_batches(cfg, 4, 16, 3, model.device)

    def fresh():
        return init_train_state(model, torch.Generator(device=model.device)
                                .manual_seed(0), opt_cfg)

    straight = fresh()
    for b in bs:
        straight, m_straight = step_fn(straight, b)
    state = fresh()
    for b in bs[:2]:
        state, _ = step_fn(state, b)
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save(tmp, 2, state)
        restored = checkpoint.restore(tmp, state)
    restored, m_resumed = step_fn(restored, bs[2])
    torch.cuda.synchronize()
    differ = [key for (key, a), (_, b) in zip(
        tree_leaves_with_paths(straight), tree_leaves_with_paths(restored))
        if not torch.equal(a, b)]
    same_loss = torch.equal(m_straight["loss"], m_resumed["loss"])
    print("train_resume " + json.dumps(
        {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
         "steps": 3, "checkpoint_at": 2, "loss": float(m_resumed["loss"]),
         "bit_equal": not differ and same_loss, "leaves_differing": differ}),
        flush=True)
    if differ or not same_loss:
        raise SystemExit(f"FAIL resume {cfg.name}: {len(differ)} leaves "
                         "differ from the uninterrupted run")


def train_cell(cfg, B, S, f32_cfg, resume=False, device=None,
               f32_hold="step", full_layers=None, profile_layers=None):
    """Phases 5a-5g on ``cfg`` at full width: ``TRAIN_STEPS`` AdamW steps
    (the launcher's schedule rule) through ``make_train_step`` on batches
    of the launcher's ``DataLoader`` copy, each step's launches counted
    from 0 and held: on F flash layers (all but MLA's, the VLM's cross
    layers and RWKV's) 2 F flash forwards (remat recomputes each layer's)
    and F backward calls, counted by mask as well; on M MoE layers 2 M
    router forwards and M router backward calls; on R RWKV layers 2 R WKV
    forwards and R WKV backward calls; no decode launch; step
    seconds, tokens/s, peak memory beside the reckoned train state (12
    bytes a bf16 parameter: param, grad, f32 m and v); one more profiled
    step, on the first ``profile_layers`` layers where given.  A VLM's
    cross gates are set to ``VLM_GATE`` (at the init's 0 every cross weight
    but the gates gets a zero grad).  Holds (i) step 0's loss against the
    plain versions' (forward, no grad), (ii) on ``f32_cfg`` (its params
    drawn from seed 0 after the bf16 state is freed) ``held_f32_step``, or
    with ``f32_hold="grads"`` ``held_f32_grads``, and with ``resume`` (iii)
    ``resume_check``.  ``full_layers``: the architecture's depth where
    ``cfg``'s is cut.  Returns (the launches of the counted steps, the
    profile, the peak memory in GB)."""
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.models.decoder import build_layout
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    wrappers = train_wrappers()
    model = build_model(cfg, device=device)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(2, TRAIN_STEPS // 10),
                          total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=model.device)
                             .manual_seed(0), opt_cfg)
    gated = set_gates(state["params"], cfg, VLM_GATE) if cfg.vision else 0
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    reckoned = 12 * n_params / 1e9
    E = cfg.encdec.n_enc_layers if cfg.encdec else 0
    L = cfg.n_layers
    layout = build_layout(cfg)
    flash_layers = sum(g.n for g in layout if not g.spec.mla
                       and g.spec.kind not in ("cross", "rwkv"))
    moe_layers = sum(g.n for g in layout if g.spec.kind == "moe")
    rwkv_layers = sum(g.n for g in layout if g.spec.kind == "rwkv")
    cross_layers = L if cfg.encdec else 0
    depth = f"{L} of {full_layers}" if full_layers else f"{L}"
    moe = (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}" if cfg.moe
           else "")
    gates = (f", {gated} gated cross layers (gates {VLM_GATE})" if gated
             else "")
    print(f"train params: {cfg.name} {cfg.dtype}, "
          f"{f'{E} encoder + ' if E else ''}{depth} layers x d_model "
          f"{cfg.d_model}{moe}{gates}, {n_params / 1e9:.3f} B parameters, "
          f"remat {cfg.remat}, state "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (reckoned train "
          f"state {reckoned:.1f} GB) in {time.perf_counter() - t0:.1f} s; "
          f"batch {B} x {S}", flush=True)
    batches = train_batches(cfg, B, S, TRAIN_STEPS + 1, model.device)
    # (i) step 0's loss with the plain versions, forward only
    with torch.no_grad(), patched(train_plains()):
        plain_loss = float(model.train_loss(state["params"], batches[0]))
    calls = E + flash_layers + cross_layers     # flash calls a forward
    non_causal = E + cross_layers
    fwd = 2 if cfg.remat else 1
    want = {"flash_attention": fwd * calls, "flash_attention_bwd": calls,
            "decode_attention": 0, "moe_routing": fwd * moe_layers,
            "moe_routing_bwd": moe_layers, "rwkv_scan": fwd * rwkv_layers,
            "rwkv_scan_bwd": rwkv_layers}
    want_masks = {"forward": {"causal": fwd * (calls - non_causal),
                              "non_causal": fwd * non_causal},
                  "backward": {"causal": calls - non_causal,
                               "non_causal": non_causal}}
    step_fn = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    totals = {k: 0 for k in wrappers}
    for step, batch in enumerate(batches[:TRAIN_STEPS]):
        before = launch_counts(wrappers)
        stack, masks = mask_counts()
        t_step = time.perf_counter()
        with stack:
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t_step
        got = {k: v - before[k] for k, v in launch_counts(wrappers).items()}
        for k, v in got.items():
            totals[k] += v
        print("train_step " + json.dumps({
            "arch": cfg.name, "step": step, "loss": loss,
            "lr": float(metrics["lr"]),
            "grad_norm": float(metrics["grad_norm"]), "step_s": step_s,
            "tokens_per_s": B * S / step_s, "launches": got,
            "flash_calls_by_mask": masks,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reckoned_state_gb": reckoned}),
            flush=True)
        if got != want or masks != want_masks:
            raise SystemExit(f"FAIL train {cfg.name} step {step}: launches "
                             f"{got} by mask {masks}, expected {want}, "
                             f"{want_masks}")
        if not math.isfinite(loss):
            raise SystemExit(f"FAIL train {cfg.name}: loss {loss}")
        if step == 0:
            rel = abs(loss - plain_loss) / abs(plain_loss)
            print("train_loss_hold " + json.dumps(
                {"arch": cfg.name, "dtype": cfg.dtype, "loss_kernels": loss,
                 "loss_plain": plain_loss, "rel": rel,
                 "bound": TRAIN_LOSS_REL}), flush=True)
            if rel > TRAIN_LOSS_REL:
                raise SystemExit(f"FAIL train {cfg.name}: step 0's loss "
                                 f"{loss} against {plain_loss}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if profile_layers:      # the profile on the first layers, cut apart
        pcfg = dataclasses.replace(cfg, n_layers=profile_layers)
        opt = state["opt"]
        state = {"params": first_layers(state["params"], cfg, profile_layers),
                 "opt": {"m": first_layers(opt["m"], cfg, profile_layers),
                         "v": first_layers(opt["v"], cfg, profile_layers),
                         "step": opt["step"]}}
        del opt
        torch.cuda.empty_cache()
        profile = profiled_step(build_model(pcfg, device=model.device), state,
                                batches[TRAIN_STEPS], opt_cfg)
    else:
        profile = profiled_step(model, state, batches[TRAIN_STEPS], opt_cfg)
    print("training " + json.dumps({
        "arch": cfg.name, "dtype": cfg.dtype, "layers": L,
        "steps": TRAIN_STEPS, "batch": B, "seq": S, "launches": totals,
        "peak_memory_gb": peak, "reckoned_state_gb": reckoned,
        "profiled_layers": profile["layers"]}), flush=True)
    del state, batches
    torch.cuda.empty_cache()
    # (ii) one f32 step, kernels against plain versions
    model32 = build_model(f32_cfg, device=model.device)
    params32 = model32.init_params(torch.Generator(device=model.device)
                                   .manual_seed(0))
    if f32_cfg.vision:
        set_gates(params32, f32_cfg, VLM_GATE)
    batch32 = train_batches(f32_cfg, B, S, 1, model.device)[0]
    if f32_hold == "grads":
        held_f32_grads(model32, params32, batch32, wrappers)
    else:
        held_f32_step(model32, params32, batch32, opt_cfg, wrappers)
    del params32, batch32
    torch.cuda.empty_cache()
    if resume:
        resume_check(cfg.name, device=device)
    return totals, profile, peak


def vlm_train_cut(cfg):
    """The VLM training cell's depth: the deepest multiple of 5 layers
    whose train state, 12 bytes a parameter (bf16 param and grad, f32 m
    and v), leaves ``VLM_TRAIN_ROOM_GB`` of ``CARD_GB`` for activations.
    Parameters reckoned from ``cfg``'s shapes: the embedding and the head,
    and a layer's attention (q, k, v, o), gated MLP and two norms, a cross
    layer's two gates besides.  Prints the reckoning at every depth."""
    from repro_torch.models.decoder import build_layout
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * D * H * hd + 2 * D * K * hd + 3 * D * cfg.d_ff + 2 * D
             + (2 * hd if cfg.qk_norm else 0))
    state_gb = {}
    for n in range(5, cfg.n_layers + 1, 5):
        cross = sum(g.n for g in build_layout(dataclasses.replace(
            cfg, n_layers=n)) if g.spec.kind == "cross")
        params = 2 * cfg.vocab * D + D + n * layer + 2 * cross
        state_gb[n] = 12 * params / 1e9
    depth = max(n for n, gb in state_gb.items()
                if gb <= CARD_GB - VLM_TRAIN_ROOM_GB)
    print("vlm_train_cut " + json.dumps(
        {"arch": cfg.name, "reckoned_state_gb_by_layers": state_gb,
         "card_gb": CARD_GB, "room_gb": VLM_TRAIN_ROOM_GB,
         "layers": depth}), flush=True)
    return depth


# ---------------------------------------------------------------------------
# 5h. the one-device mesh


@contextmanager
def one_device_mesh(device=None):
    """A world-size-1 process group on a ``FileStore`` in a temporary
    directory (no TCP listener; ``nccl`` on the card, ``gloo`` where
    ``device="cpu"`` rehearses it) and the (1, 1) ``data x model`` mesh on
    it; the group is destroyed on the way out, so no later code sees it."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    cpu = device == "cpu"
    if not cpu:
        torch.cuda.set_device(torch.cuda.current_device())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo" if cpu else "nccl", rank=0, world_size=1,
            store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            yield make_mesh((1, 1), ("data", "model"),
                            device_type="cpu" if cpu else "cuda")
        finally:
            dist.destroy_process_group()


@contextmanager
def active(mesh):
    """``mesh`` the active mesh, cleared on the way out."""
    from repro_torch.distributed import sharding as sh
    sh.set_active_mesh(mesh)
    try:
        yield
    finally:
        sh.set_active_mesh(None)


def gathered(tree):
    """A tree's DTensors as their full tensors (on the (1, 1) mesh, each
    rank's local tensor is the whole)."""
    from torch.distributed.tensor import DTensor
    from repro_torch._tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, tree)


def differing(a, b):
    """The paths of the leaves of two trees that are not bit-equal."""
    import torch
    from repro_torch._tree import tree_leaves_with_paths
    return [key for (key, x), (_, y) in zip(tree_leaves_with_paths(gathered(a)),
                                            tree_leaves_with_paths(gathered(b)))
            if not torch.equal(x, y)]


def timed_call(fn, *args):
    """(fn(*args), host seconds until it returned, seconds until the card
    finished)."""
    import torch
    t0 = time.perf_counter()
    out = fn(*args)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return out, host, time.perf_counter() - t0


def mesh_train(mesh, cfg, steps, B, S, device=None):
    """``steps`` AdamW steps of ``cfg`` (at full width, bf16, remat, its
    depth cut) on ``DataLoader`` batches: once on plain tensors and
    once on DTensors of the (1, 1) mesh (params by ``TRAIN_RULES``, moments
    by ``opt_pspecs``, the batch by ``batch_pspecs``, ``grad_shardings``
    from ``opt_pspecs``), from the same state.  Each step's loss and grad
    norm, every param, m and v leaf after them, and each kernel's launches
    must be equal, bit for bit.  Returns the mesh run's launches."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.registry import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import (init_train_state,
                                                 make_train_step)
    model = build_model(cfg, device=device)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=20)
    plain = init_train_state(model, torch.Generator(device=model.device)
                             .manual_seed(0), opt_cfg)
    params = plain["params"]
    p_sh = sh.to_shardings(sh.param_pspecs(params, mesh, sh.TRAIN_RULES),
                           mesh)
    o_sh = sh.to_shardings(sh.opt_pspecs(params, mesh), mesh)

    def copy(tree):
        return tree_map(lambda t: t.clone(), tree)

    dist_state = {"params": sh.distribute(copy(params), p_sh),
                  "opt": {"m": sh.distribute(copy(plain["opt"]["m"]), o_sh),
                          "v": sh.distribute(copy(plain["opt"]["v"]), o_sh),
                          "step": plain["opt"]["step"].clone()}}
    batches = train_batches(cfg, B, S, steps, model.device)
    wrappers = train_wrappers()
    runs = {}
    for name in ("plain", "mesh"):
        step_fn = make_train_step(model, opt_cfg,
                                  grad_shardings=o_sh if name == "mesh"
                                  else None)
        state = plain if name == "plain" else dist_state
        for fn in wrappers.values():
            fn.launches = 0
        metrics, host, wall = [], [], []
        with (active(mesh) if name == "mesh" else ExitStack()):
            for batch in batches:
                if name == "mesh":
                    batch = sh.distribute(batch, sh.to_shardings(
                        sh.batch_pspecs(batch, mesh), mesh))
                (state, m), h, w = timed_call(step_fn, state, batch)
                metrics.append({k: gathered(m[k]).clone()
                                for k in ("loss", "grad_norm")})
                host.append(h)
                wall.append(w)
        runs[name] = dict(state=state, metrics=metrics, host=host, wall=wall,
                          launches=launch_counts(wrappers))
        if name == "plain":
            plain = state
    p, m = runs["plain"], runs["mesh"]
    metrics_equal = all(torch.equal(a[k], b[k]) for a, b in zip(
        p["metrics"], m["metrics"]) for k in ("loss", "grad_norm"))
    leaves = {part: differing(p["state"][part[0]][part[1]] if part[1]
                              else p["state"][part[0]],
                              m["state"][part[0]][part[1]] if part[1]
                              else m["state"][part[0]])
              for part in (("params", None), ("opt", "m"), ("opt", "v"))}
    n_params = sum(t.numel() for t in tree_leaves(params))
    line = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "params_b": n_params / 1e9, "batch": [B, S],
            "steps": steps, "mesh": dict(zip(mesh.mesh_dim_names,
                                             mesh.shape)),
            "loss": [float(x["loss"]) for x in m["metrics"]],
            "grad_norm": [float(x["grad_norm"]) for x in m["metrics"]],
            "metrics_bit_equal": metrics_equal,
            "leaves_differing": {"/".join(k for k in part if k): v
                                 for part, v in leaves.items()},
            "launches": {"plain": p["launches"], "mesh": m["launches"]},
            "step_s": {"plain": p["wall"], "mesh": m["wall"]},
            "host_s": {"plain": p["host"], "mesh": m["host"]}}
    print("mesh_train " + json.dumps(line), flush=True)
    if (not metrics_equal or any(leaves.values())
            or p["launches"] != m["launches"]
            or not any(p["launches"].values())):
        raise SystemExit(f"FAIL mesh train {cfg.name}: {line}")
    del runs, plain, dist_state, state, params
    return m["launches"]


def mesh_serve(mesh, cfg, device=None):
    """Serving on the (1, 1) mesh: ``REQUESTS`` requests of batch
    ``SERVE_BATCH`` x ``PROMPT`` and ``MESH_GEN`` decode steps of ``cfg``
    (at full width, bf16, its depth cut) on plain tensors, on
    DTensors (params by ``PARAM_RULES``, caches by ``cache_pspecs``), on
    DTensors again with ``ONEHOT_CACHE_UPDATE`` and once more with
    ``SHARDED_DECODE_ATTN`` (the sharded flash-decode: the kernel's
    log-sum-exp instance on the one shard, merged over the one-rank
    ``model`` group): every step's logits and the flash and
    decode-attention launches bit-equal, the plain run's greedy tokens fed
    to all four; in the sharded run every decode step of every layer
    merges and, on the card, every decode-attention kernel of a profiled
    step is the lse instance.  Returns the mesh runs' launches by run."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import layers as model_layers
    from repro_torch.models.registry import build_model
    from repro_torch.serving.kvcache import pad_cache
    model = build_model(cfg, device=device)
    params = model.init_params(torch.Generator(device=model.device)
                               .manual_seed(0))
    dparams = sh.distribute(params, sh.to_shardings(
        sh.param_pspecs(params, mesh), mesh))
    rng = torch.Generator(device=model.device).manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (SERVE_BATCH, PROMPT),
                             generator=rng, device=model.device)
               for _ in range(REQUESTS)]
    wrappers = {k: v for k, v in kernel_wrappers().items()
                if k in ("flash_attention", "decode_attention")}
    buf = PROMPT + MESH_GEN + 8

    def on_mesh(batch):
        return sh.distribute(batch, sh.to_shardings(
            sh.batch_pspecs(batch, mesh), mesh))

    def serve(name, tokens):
        sharded = name != "plain"
        p = dparams if sharded else params
        logits_all, host, wall = [], [], []
        profiled = name == "mesh sharded" and device is None   # the card
        for r, prompt in enumerate(prompts):
            batch = {"tokens": prompt}
            (logits, caches), h, w = timed_call(
                model.prefill, p, on_mesh(batch) if sharded else batch)
            template = model.init_cache(SERVE_BATCH, buf)
            if sharded:
                template = sh.distribute(template, sh.to_shardings(
                    sh.cache_pspecs(template, mesh), mesh))
            caches = pad_cache(caches, template)
            out = [gathered(logits)]
            for i in range(MESH_GEN):
                if name == "plain":
                    tokens[r].append(torch.argmax(out[-1], -1)
                                     .to(torch.int32)[:, None])
                step = {"token": tokens[r][i]}
                step = on_mesh(step) if sharded else step
                if profiled:
                    # the first step once more, uncounted, under the
                    # profiler: its decode kernels (it writes the same
                    # keys and values into the same slot).  The device
                    # side of a trace now and then misses a kernel: the
                    # step is traced again, up to 3 times, until it shows
                    # one a layer
                    profiled = False
                    before = {k: fn.launches for k, fn in wrappers.items()}
                    n_merged = len(merged)
                    for _ in range(3):
                        with torch.profiler.profile(activities=[
                                torch.profiler.ProfilerActivity.CUDA]) as prof:
                            model.decode(p, caches,
                                         {**step, "pos": PROMPT + i})
                            torch.cuda.synchronize()
                        decode_kernels[:] = [
                            evt.name for evt in prof.events()
                            if "decode_attention_kernel" in evt.name
                            and getattr(evt, "device_type", None)
                            == torch.autograd.DeviceType.CUDA]
                        if len(decode_kernels) == cfg.n_layers:
                            break
                    for k, fn in wrappers.items():
                        fn.launches = before[k]
                    del merged[n_merged:]
                (logits, caches), h, w = timed_call(
                    model.decode, p, caches, {**step, "pos": PROMPT + i})
                host.append(h)
                wall.append(w)
                out.append(gathered(logits))
            logits_all.append(out)
        return logits_all, host, wall

    tokens = [[] for _ in prompts]
    runs, decode_kernels, merged = {}, [], []
    sharded_fn = model_layers.sharded_decode_attention

    def counted(*args):
        out = sharded_fn(*args)
        merged.append(out is not None)
        return out

    for name in ("plain", "mesh", "mesh onehot", "mesh sharded"):
        with (active(mesh) if name != "plain" else ExitStack()):
            model_layers.ONEHOT_CACHE_UPDATE = name == "mesh onehot"
            model_layers.SHARDED_DECODE_ATTN = name == "mesh sharded"
            model_layers.sharded_decode_attention = counted
            try:
                for fn in wrappers.values():
                    fn.launches = 0
                logits, host, wall = serve(name, tokens)
                launches = launch_counts(wrappers)
            finally:
                model_layers.ONEHOT_CACHE_UPDATE = False
                model_layers.SHARDED_DECODE_ATTN = False
                model_layers.sharded_decode_attention = sharded_fn
        runs[name] = dict(logits=logits, host=host, wall=wall,
                          launches=launches)
    ref = runs["plain"]
    held = {name: all(torch.equal(a, b) for ra, rb in zip(
        ref["logits"], run["logits"]) for a, b in zip(ra, rb))
        for name, run in runs.items() if name != "plain"}
    lse_instance = [("true" in n or "Lb1E" in n) for n in decode_kernels]
    line = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "requests": REQUESTS, "batch": [SERVE_BATCH, PROMPT],
            "decode_steps": MESH_GEN,
            "logits_bit_equal_to_plain": held,
            "launches": {k: r["launches"] for k, r in runs.items()},
            "sharded_decode": {
                "merges": sum(merged), "calls": len(merged),
                "profiled_step_decode_kernels": len(decode_kernels),
                "lse_instance": all(lse_instance) and bool(lse_instance),
                "kernel_names": sorted(set(decode_kernels))},
            "decode_step_s": {k: statistics.fmean(r["wall"])
                              for k, r in runs.items()},
            "decode_step_host_s": {k: statistics.fmean(r["host"])
                                   for k, r in runs.items()}}
    print("mesh_serve " + json.dumps(line), flush=True)
    want_merges = cfg.n_layers * MESH_GEN * REQUESTS
    if (not all(held.values())
            or any(r["launches"] != ref["launches"] for r in runs.values())
            or not all(ref["launches"].values())
            or merged != [True] * want_merges
            or (device is None and len(decode_kernels) != cfg.n_layers)
            or not all(lse_instance)):
        raise SystemExit(f"FAIL mesh serve {cfg.name}: {line}")
    return {"": runs["mesh"]["launches"],
            " sharded-decode": runs["mesh sharded"]["launches"]}


def mesh_phase(train_cells, serve_cfg, B, S, device=None):
    """Phase 5h: ``mesh_train`` of each (config, steps) of ``train_cells``
    and ``mesh_serve`` of ``serve_cfg`` on a (1, 1) mesh.  Returns the mesh
    runs' launches by path."""
    import torch
    paths = {}
    with one_device_mesh(device) as mesh:
        for cfg, steps in train_cells:
            paths[f"mesh train {cfg.name}"] = mesh_train(mesh, cfg, steps, B,
                                                         S, device)
            torch.cuda.empty_cache()
        for run, launches in mesh_serve(mesh, serve_cfg, device).items():
            paths[f"mesh serve {serve_cfg.name}{run}"] = launches
        torch.cuda.empty_cache()
    print(f"mesh card: {card_line() if device is None else 'cpu'}",
          flush=True)
    return paths


DRYRUN_CELL = ("h2o-danube-1.8b", "decode_32k")
DRYRUN_FLOPS = 576_632_913_920   # the JAX package's dot_general count


def dryrun_phase():
    """Phase 5i: ``python -m repro_torch.launch.dryrun`` on ``DRYRUN_CELL``
    with ``--mesh both``, without and with ``--opt``, in two subprocesses
    at once (this process's default group is not the fake one they need;
    they use no card): every record
    ``ok`` on 256 and 512 fake ranks, its matmul FLOPs plus the decode
    kernel's equal to the JAX package's count, the global counts the same
    with and without the switch.  Returns the records."""
    import tempfile
    arch, shape = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    records = {}
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        procs = {opt: subprocess.Popen(      # both at once: meta, no card
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--mesh", "both",
             "--out", out, *opt], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for opt in ((), ("--opt",))}
        for opt, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            if proc.returncode != 0:
                raise SystemExit(f"FAIL dry run {opt}: rc {proc.returncode}"
                                 f"\n{stdout[-3000:]}\n{stderr[-3000:]}")
            print(f"dryrun {' '.join(opt) or '(baseline)'}: done after "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        for path in sorted(Path(out).glob("*.json")):
            records[path.stem] = json.loads(path.read_text())
    keys = ("status", "n_devices", "run_s", "dot_flops_global",
            "kernel_flops_global", "bytes_global",
            "collective_bytes_per_device", "collective_counts", "memory")
    for name, rec in records.items():
        print(f"dryrun {name}: " + json.dumps({k: rec.get(k) for k in keys}),
              flush=True)
    want = {f"{arch}__{shape}__{m}{t}" for m in ("single", "multi")
            for t in ("", "__opt")}
    flops = {name: rec.get("dot_flops_global", 0)
             + rec.get("kernel_flops_global", {}).get("decode_attention", 0)
             for name, rec in records.items()}
    if (set(records) != want
            or any(r["status"] != "ok" for r in records.values())
            or any(f != DRYRUN_FLOPS for f in flops.values())
            or {records[n]["n_devices"] for n in want if "single" in n}
            != {256}
            or {records[n]["n_devices"] for n in want if "multi" in n}
            != {512}):
        raise SystemExit(f"FAIL dry run: {sorted(records)}, flops {flops}")
    return records


def phase_done(name, t0):
    """Print a phase's seconds on a line of its own; the next phase's
    start."""
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return time.perf_counter()


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
    from repro_torch.kernels import _build
    from repro_torch.kernels import scheduler_score as ss

    # 1. the card, the build (one nvcc per source, all started together)
    t_phase = time.perf_counter()
    resolve_device()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = next((r for key, r in HBM_RATE if key in name), 3.35e12)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; HBM rate {rate / 1e12} TB/s; "
          f"{os.cpu_count()} CPUs", flush=True)
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
    t_phase = phase_done("1 (card, build)", t_phase)

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
    t_phase = phase_done("2a (scoring kernels)", t_phase)

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
    t_phase = phase_done("2b (tick kernels)", t_phase)

    # 2c-2d. the attention kernels against their plain versions
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import rwkv_scan as rs
    if _build.load("decode_attention").synergai_decode_tile() != da.TILE:
        raise SystemExit("FAIL decode_attention: the kernel's tile is not "
                         "decode_attention.TILE")
    _, _, nh, nkv, dh, edge = DECODE_HOLDS[-1]
    ends = [e for _, e in da.split_keys(
        da.plan_splits(SERVE_BATCH, nkv, nh // nkv, edge, dh), edge)]
    if edge % da.TILE or any(e % da.TILE for e in ends):
        raise SystemExit(f"FAIL decode_attention: k_valid {edge} does not "
                         f"end on a split boundary ({ends})")
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
        for shape in DECODE_LSE_HOLDS:
            hold_decode_lse(*shape, dtype_name, rate)
        torch.cuda.empty_cache()
    hold_decode_streams()
    t_phase = phase_done("2c-2d (attention kernels)", t_phase)

    # 2e. the WKV scan against its plain version, bit for bit
    lib = _build.load("rwkv_scan")
    if (lib.synergai_rwkv_lanes(), lib.synergai_rwkv_cols()) != (rs.LANES,
                                                                 rs.COLS):
        raise SystemExit("FAIL rwkv_scan: the kernel's lanes and columns "
                         "are not rwkv_scan.LANES and COLS")
    rwkv_holds = {shape + (dtype_name,): hold_rwkv(*shape, dtype_name, rate)
                  for dtype_name in ("float32", "bfloat16")
                  for shape in RWKV_HOLDS}
    torch.cuda.empty_cache()
    t_phase = phase_done("2e (WKV scan)", t_phase)

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
    t_phase = phase_done("2f (router)", t_phase)

    # 2h. the flash backward against its plain version, the forward's lse
    bwd_holds = {shape + (dtype_name,): hold_flash_bwd(*shape, dtype_name,
                                                       rate)
                 for dtype_name in ("float32", "bfloat16")
                 for shape in FLASH_BWD_HOLDS}
    t_phase = phase_done("2h (flash backward)", t_phase)

    # 2i. the router backward against its plain version, bit for bit
    if _build.load("moe_routing_bwd").synergai_moe_routing_bwd_chunk() != \
            mr.DW_CHUNK:
        raise SystemExit("FAIL moe_routing_bwd: the kernel's dW chunk is "
                         "not moe_routing.DW_CHUNK")
    routing_bwd_holds = {shape + (dtype_name,): hold_routing_bwd(
        *shape, dtype_name, rate) for dtype_name in ("bfloat16", "float32")
        for shape in ROUTING_BWD_HOLDS}
    torch.cuda.empty_cache()
    t_phase = phase_done("2i (router backward)", t_phase)

    # 2j. the WKV backward against its plain version, bit for bit, at
    # every column split the wrapper can pick
    bwd_lib = _build.load("rwkv_scan_bwd")
    if (_build.load("rwkv_scan").synergai_rwkv_chunk(),
            bwd_lib.synergai_rwkv_bwd_chunk()) != (rs.CHUNK, rs.CHUNK):
        raise SystemExit("FAIL rwkv_scan_bwd: the kernels' chunk is not "
                         "rwkv_scan.CHUNK")
    for hd in rs.HEAD_DIMS:
        splits = rs.bwd_splits(hd)
        if ((bwd_lib.synergai_rwkv_bwd_lanes(hd),
             bwd_lib.synergai_rwkv_bwd_cols(hd)) != rs.BWD_LAYOUT[hd]
                or (bwd_lib.synergai_rwkv_bwd_min_split(hd),
                    bwd_lib.synergai_rwkv_bwd_max_split(hd)) != (
                        splits[0], splits[-1])
                or bwd_lib.synergai_rwkv_bwd_steps() != rs.BWD_STEPS):
            raise SystemExit(f"FAIL rwkv_scan_bwd: the kernel's layout or "
                             f"splits at hd {hd} are not rwkv_scan's")
        held = {rs.bwd_split(B, H, hd_) for B, _, H, hd_, _ in
                RWKV_BWD_HOLDS if hd_ == hd}
        if held != set(splits):
            raise SystemExit(f"FAIL rwkv_scan_bwd: RWKV_BWD_HOLDS reach the "
                             f"splits {sorted(held)} of {splits} at hd {hd}")
    rwkv_bwd_holds = {shape: hold_rwkv_bwd(*shape, rate)
                      for shape in RWKV_BWD_HOLDS}
    t_phase = phase_done("2j (WKV backward)", t_phase)

    # 3, 3f-3g. the scheduling path at full size, drift, the comparison
    sched = scheduling_path()
    fleet = sched.fleet
    t_phase = phase_done("3, 3f-3g (scheduling, drift, comparison)", t_phase)

    # 4-6. the serving path at full width, its parity, a decode-step profile
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
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
    attn_plains = attention_plains()
    parity(model, params, prompts[0], "bfloat16", attn, attn_plains)
    profile_line = decode_profile(model, params, prompts[0])
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    parity(model32, params, prompts[0], "float32", attn, attn_plains)
    del params
    torch.cuda.empty_cache()
    t_phase = phase_done("4-6 (qwen3-4b)", t_phase)

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
    t_phase = phase_done("4b-6b (rwkv6-1.6b)", t_phase)

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
    t_phase = phase_done("4c-6c (phi3.5-moe)", t_phase)

    # 4d. the MLA serving path: deepseek-v2 at full width with 7 of its 60
    # layers; 4e. the VLM serving path: llama-3.2-vision at full width;
    # 4f. the hybrid serving path: hymba-1.5b at full width; 4g. the
    # encoder-decoder serving path: seamless-m4t-medium at full width
    dcfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    mla_launches, mla_profile, absorb_profile = serve_mla(
        dcfg, MLA_F32_LAYERS, get_config(MLA_ARCH).n_layers)
    t_phase = phase_done("4d (deepseek-v2)", t_phase)
    vlm_launches, vlm_profile = serve_vlm(get_config(VLM_ARCH),
                                          VLM_F32_LAYERS)
    t_phase = phase_done("4e (llama-3.2-vision)", t_phase)
    hymba_launches, hymba_profile, hymba_prefill = serve_hymba(
        get_config(HYMBA_ARCH))
    t_phase = phase_done("4f (hymba-1.5b)", t_phase)
    encdec_launches, encdec_profile = serve_encdec(get_config(ENCDEC_ARCH))
    t_phase = phase_done("4g (seamless-m4t-medium)", t_phase)

    # 5a-5b. training at full width: qwen3-4b (its f32 step on 4 layers,
    # resume equivalence at the reduced size), seamless-m4t-medium (its f32
    # step at full depth)
    tcfg = get_config(TRAIN_ARCH)
    train_launches, train_profile, train_peak = train_cell(
        tcfg, TRAIN_BATCH, TRAIN_SEQ,
        dataclasses.replace(tcfg, n_layers=TRAIN_F32_LAYERS, dtype="float32"),
        resume=True)
    t_phase = phase_done(f"5a (train {TRAIN_ARCH})", t_phase)
    ecfg = get_config(ENCDEC_ARCH)
    etrain_launches, etrain_profile, etrain_peak = train_cell(
        ecfg, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ,
        dataclasses.replace(ecfg, dtype="float32"))
    t_phase = phase_done(f"5b (train {ENCDEC_ARCH})", t_phase)

    # 5c-5d. training the MoE family at full width: phi3.5-moe with 4 of
    # its 32 layers (its f32 step on 1, resume equivalence at the reduced
    # size), deepseek-v2 (MLA) with 1 of its 60 (its f32 loss and grads)
    pcfg = dataclasses.replace(get_config(MOE_ARCH),
                               n_layers=MOE_TRAIN_LAYERS)
    moe_train_launches, moe_train_profile, moe_train_peak = train_cell(
        pcfg, TRAIN_BATCH, TRAIN_SEQ,
        dataclasses.replace(pcfg, n_layers=MOE_TRAIN_F32_LAYERS,
                            dtype="float32"),
        resume=True, full_layers=get_config(MOE_ARCH).n_layers)
    t_phase = phase_done(f"5c (train {MOE_ARCH})", t_phase)
    tdcfg = dataclasses.replace(get_config(MLA_ARCH),
                                n_layers=MLA_TRAIN_LAYERS)
    mla_train_launches, mla_train_profile, mla_train_peak = train_cell(
        tdcfg, MLA_TRAIN_BATCH, MLA_TRAIN_SEQ,
        dataclasses.replace(tdcfg, dtype="float32"), f32_hold="grads",
        full_layers=get_config(MLA_ARCH).n_layers)
    t_phase = phase_done(f"5d (train {MLA_ARCH})", t_phase)

    # 5e-5f. training the hybrid and VLM families at full width: hymba-1.5b
    # at full depth (its f32 step and its profile on 4 layers),
    # llama-3.2-vision cut to 20 of its 40 layers (its f32 step on 5)
    hycfg = get_config(HYMBA_ARCH)
    hymba_train_launches, hymba_train_profile, hymba_train_peak = train_cell(
        hycfg, TRAIN_BATCH, TRAIN_SEQ,
        dataclasses.replace(hycfg, n_layers=HYMBA_TRAIN_F32_LAYERS,
                            dtype="float32"),
        profile_layers=HYMBA_TRAIN_PROFILE_LAYERS)
    t_phase = phase_done(f"5e (train {HYMBA_ARCH})", t_phase)
    vtcfg = dataclasses.replace(get_config(VLM_ARCH),
                                n_layers=vlm_train_cut(get_config(VLM_ARCH)))
    vlm_train_launches, vlm_train_profile, vlm_train_peak = train_cell(
        vtcfg, TRAIN_BATCH, TRAIN_SEQ,
        dataclasses.replace(vtcfg, n_layers=VLM_TRAIN_F32_LAYERS,
                            dtype="float32"),
        full_layers=get_config(VLM_ARCH).n_layers)
    t_phase = phase_done(f"5f (train {VLM_ARCH})", t_phase)

    # 5g. training the RWKV family: rwkv6-1.6b at full width and depth (its
    # f32 step on 2 layers)
    rwcfg = get_config(RWKV_ARCH)
    rwkv_train_launches, rwkv_train_profile, rwkv_train_peak = train_cell(
        rwcfg, TRAIN_BATCH, TRAIN_SEQ,
        dataclasses.replace(rwcfg, n_layers=RWKV_TRAIN_F32_LAYERS,
                            dtype="float32"))
    t_phase = phase_done(f"5g (train {RWKV_ARCH})", t_phase)

    # 5h. the one-device mesh: training and serving on DTensors of a (1, 1)
    # mesh, bit-equal to plain tensors through the same kernels
    mesh_launches = mesh_phase(
        [(dataclasses.replace(get_config(arch), n_layers=layers), steps)
         for arch, layers, steps in MESH_TRAIN],
        dataclasses.replace(get_config(MESH_SERVE[0]),
                            n_layers=MESH_SERVE[1]), TRAIN_BATCH, TRAIN_SEQ)
    t_phase = phase_done("5h (one-device mesh)", t_phase)

    # 5i. the dry run of the production meshes on meta tensors, no card
    dryrun_phase()
    t_phase = phase_done("5i (dry run)", t_phase)

    # 7. the launch floor, the kernels at their paths' mean shapes, and the
    # result
    print("launch floor: " + json.dumps(
        {"device_ms": launch_floor_ms(),
         "op": "torch.add of two one-element float32 tensors"}), flush=True)
    W = len(fleet)
    rows = []
    # each path's launches, counted from 0 just before it: the scoring
    # kernels' main paths (v2 also in the v2 drift run), the tick kernels'
    # resident runs of 3 and 3f and the resident SynergAI runs of 3g
    main_path, resident, drift = sched.main_path, sched.resident, sched.drift
    by_path = {"scheduler_score": {"job-v1": main_path["scheduler_score"][0]},
               "scheduler_score_v2": {
                   "batched-streaming-v2": main_path["scheduler_score_v2"][0],
                   "drift-v2-online": sched.drift_v2[0]}}
    for kname in ("tick_score_kernel", "greedy_place_kernel"):
        by_path[kname] = {
            **{label: run.launches[kname] for label, run in resident.items()},
            **{f"drift-{label}": run.launches[kname]
               for label, run in drift.items()},
            "paper-experiments": sched.paper_launches[kname]}
    for kname, k in kernels.items():
        _, mean_rows, _ = main_path[kname]
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
            "replaces": k["replaces"],
            "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": max(worst[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": r["device_ms"],
            "shape": [J, W]})
    # the tick kernels: launches summed over the resident paths, held at
    # the job-resident run's mean queue length and pool rows
    mean_j = resident["job-resident"].mean_j
    mean_cap = resident["job-resident"].mean_cap
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
            "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": max(worst[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "device_ms": r["device_ms"],
            "shape": [J, cap, W]})
    # the attention kernels at the serving path's shapes in bf16: flash at
    # the prompt, decode at the mean k_valid of the 31 decode steps
    flash = hold_flash(SERVE_BATCH, PROMPT, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, None, True, "bfloat16", rate)
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
        # the attention serving paths: qwen3-4b, phi3.5-moe, the VLM's
        # self layers (the same shapes as qwen3-4b's), hymba and
        # seamless-m4t (held at their own shapes in 2c-2d)
        paths = {SERVE_ARCH: serve_launches[kname],
                 MOE_ARCH: moe_launches[kname],
                 VLM_ARCH: vlm_launches[kname],
                 HYMBA_ARCH: hymba_launches[kname],
                 ENCDEC_ARCH: encdec_launches[kname]}
        if kname == "flash_attention":   # the training steps' forwards
            paths.update({f"train {TRAIN_ARCH}": train_launches[kname],
                          f"train {ENCDEC_ARCH}": etrain_launches[kname],
                          f"train {MOE_ARCH}": moe_train_launches[kname],
                          f"train {HYMBA_ARCH}": hymba_train_launches[kname],
                          f"train {VLM_ARCH}": vlm_train_launches[kname]})
        rows.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kname}.cu",
            "replaces": f"src/repro/kernels/{kname}.py:{line}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(attn_worst[kname], r["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "shape": shape, "dtype": "bfloat16"})
    # the flash backward at qwen3-4b's training shape in bf16, from 2h; its
    # launches over the training paths' counted steps
    shape = (TRAIN_BATCH, TRAIN_SEQ, tcfg.n_heads, tcfg.n_kv_heads,
             tcfg.head_dim, None, True)
    r = bwd_holds[shape + ("bfloat16",)]
    paths = {f"train {TRAIN_ARCH}": train_launches["flash_attention_bwd"],
             f"train {ENCDEC_ARCH}": etrain_launches["flash_attention_bwd"],
             f"train {MOE_ARCH}": moe_train_launches["flash_attention_bwd"],
             f"train {HYMBA_ARCH}":
             hymba_train_launches["flash_attention_bwd"],
             f"train {VLM_ARCH}": vlm_train_launches["flash_attention_bwd"]}
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/training/train_step.py:40 (no Pallas "
                    "kernel: jax.value_and_grad through the XLA attention "
                    "of src/repro/models/common.py:188)",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(h["max_abs_err"] for h in bwd_holds.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "device_ms": r["device_ms"],
        "device_ms_by_kernel": r["device_ms_by_kernel"],
        "shape": list(shape[:5]), "dtype": "bfloat16", "kernels_per_call": 3})
    # the WKV scan at the RWKV serving path's shapes (its inputs are f32 in
    # the model whatever the params' dtype), from 2e: the prefill and, under
    # "decode_step", one decode step on the cache's state
    hd = rcfg.ssm.rwkv_head_dim
    pre_shape = (SERVE_BATCH, PROMPT, rcfg.d_model // hd, hd, False)
    dec_shape = (SERVE_BATCH, 1, rcfg.d_model // hd, hd, True)
    pre = rwkv_holds[pre_shape + ("float32",)]
    dec = rwkv_holds[dec_shape + ("float32",)]
    paths = {RWKV_ARCH: rwkv_launches["rwkv_scan"],
             f"train {RWKV_ARCH}": rwkv_train_launches["rwkv_scan"]}
    rows.append({
        "name": "rwkv_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
        "replaces": "src/repro/kernels/rwkv_scan.py:22",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in rwkv_holds.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None, "device_ms": pre["device_ms"],
        "shape": list(pre_shape[:4]), "dtype": "float32",
        "decode_step": dict({k: dec[k] for k in TIMES + ("bound_by",)},
                            shape=list(dec_shape[:4]))})
    # the WKV backward at rwkv6's training shape, from 2j; its launches over
    # the RWKV training path's counted steps
    shape = (TRAIN_BATCH, TRAIN_SEQ, rcfg.d_model // hd, hd, False)
    r = rwkv_bwd_holds[shape]
    rows.append({
        "name": "rwkv_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu",
        "replaces": "src/repro/training/train_step.py:40 (no Pallas "
                    "kernel: jax.value_and_grad through the WKV scan of "
                    "src/repro/models/layers.py:466)",
        "launches": rwkv_train_launches["rwkv_scan_bwd"],
        "launches_by_path": {f"train {RWKV_ARCH}":
                             rwkv_train_launches["rwkv_scan_bwd"]},
        "max_abs_err": max(h["max_abs_err"] for h in rwkv_bwd_holds.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_ms": r["device_ms"], "shape": list(shape[:4]),
        "dtype": "float32"})
    # the router at the MoE serving path's shapes (x in bf16, the model's),
    # from 2f: the prefill and, under "decode_step", one decode step
    n_exp, top_k = mcfg.moe.n_experts, mcfg.moe.top_k
    pre_shape = (SERVE_BATCH * PROMPT, mcfg.d_model, n_exp, top_k, "random")
    dec_shape = (SERVE_BATCH, mcfg.d_model, n_exp, top_k, "random")
    pre = routing_holds[pre_shape + ("bfloat16",)]
    dec = routing_holds[dec_shape + ("bfloat16",)]
    # and at deepseek-v2's path shapes, E = 160, top-6
    n_exp, top_k = dcfg.moe.n_experts, dcfg.moe.top_k
    mla_shapes = {"prefill": (SERVE_BATCH * PROMPT, dcfg.d_model, n_exp,
                              top_k, "random"),
                  "decode_step": (SERVE_BATCH, dcfg.d_model, n_exp, top_k,
                                  "random")}
    mla_holds = {
        key: dict({k: routing_holds[shape + ("bfloat16",)][k]
                   for k in TIMES + ("bound_by", "three_call_ms")},
                  shape=list(shape[:4]))
        for key, shape in mla_shapes.items()}
    paths = {MOE_ARCH: moe_launches["moe_routing"],
             MLA_ARCH: mla_launches["moe_routing"],
             f"train {MOE_ARCH}": moe_train_launches["moe_routing"],
             f"train {MLA_ARCH}": mla_train_launches["moe_routing"]}
    rows.append({
        "name": "moe_routing", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_routing.cu",
        "replaces": "src/repro/kernels/moe_routing.py:21",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(r["max_abs_err"] for r in routing_holds.values()),
        "ms": pre["ms"], "plain_ms": pre["plain_ms"],
        "bound_ms": pre["bound_ms"], "bound_by": pre["bound_by"],
        "library_ms": None, "three_call_ms": pre["three_call_ms"],
        "device_ms": pre["device_ms"], "shape": list(pre_shape[:4]),
        "dtype": "bfloat16",
        "decode_step": dict({k: dec[k] for k in TIMES + ("bound_by",)},
                            shape=list(dec_shape[:4])),
        MLA_ARCH: mla_holds})
    # the router backward at phi3.5-moe's training shape (x in bf16, the
    # model's), from 2i, and at deepseek-v2's; its launches over the two
    # MoE training paths' counted steps
    shapes = {"main": (TRAIN_BATCH * TRAIN_SEQ, pcfg.d_model,
                       pcfg.moe.n_experts, pcfg.moe.top_k, "random"),
              MLA_ARCH: (MLA_TRAIN_BATCH * MLA_TRAIN_SEQ, tdcfg.d_model,
                         tdcfg.moe.n_experts, tdcfg.moe.top_k, "random")}
    r = routing_bwd_holds[shapes["main"] + ("bfloat16",)]
    rm = routing_bwd_holds[shapes[MLA_ARCH] + ("bfloat16",)]
    paths = {f"train {MOE_ARCH}": moe_train_launches["moe_routing_bwd"],
             f"train {MLA_ARCH}": mla_train_launches["moe_routing_bwd"]}
    rows.append({
        "name": "moe_routing_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_routing_bwd.cu",
        "replaces": "src/repro/training/train_step.py:40 (no Pallas "
                    "kernel: jax.value_and_grad through the router of "
                    "src/repro/models/layers.py:311)",
        "launches": sum(paths.values()), "launches_by_path": paths,
        "max_abs_err": max(h["max_abs_err"]
                           for h in routing_bwd_holds.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
        "device_ms": r["device_ms"],
        "device_ms_by_kernel": r["device_ms_by_kernel"],
        "shape": list(shapes["main"][:4]), "dtype": "bfloat16",
        MLA_ARCH: dict({k: rm[k] for k in TIMES + ("bound_by",
                                                   "device_ms_by_kernel")},
                       shape=list(shapes[MLA_ARCH][:4]))})
    for line, key in ((profile_line, "decode_attention_share"),
                      (rwkv_profile, "wkv_share"),
                      (moe_profile, "moe_routing_share"),
                      (mla_profile, "moe_routing_share"),
                      (absorb_profile, "moe_routing_share"),
                      (vlm_profile, "decode_attention_share"),
                      (hymba_profile, "decode_attention_share"),
                      (encdec_profile, "decode_attention_share")):
        mode = f" ({line['mode']})" if "mode" in line else ""
        print(f"decode step {line['arch']}{mode}: " + json.dumps(
            {k: line[k] for k in ("host_ms_per_step", "device_ms_per_step",
                                  "idle_share", key)}))
    print(f"prefill {HYMBA_ARCH}: " + json.dumps(
        {k: hymba_prefill[k] for k in ("host_s", "device_ms", "idle_share",
                                       "mamba_recurrence_share")}))
    for line, peak in ((train_profile, train_peak),
                       (etrain_profile, etrain_peak),
                       (moe_train_profile, moe_train_peak),
                       (mla_train_profile, mla_train_peak),
                       (hymba_train_profile, hymba_train_peak),
                       (vlm_train_profile, vlm_train_peak),
                       (rwkv_train_profile, rwkv_train_peak)):
        print(f"train step {line['arch']}: " + json.dumps(
            {**{k: line[k] for k in ("layers", "host_ms", "device_ms",
                                     "idle_share", "device_ms_by_kind",
                                     "optimizer_device_ms",
                                     "loss_chunks_device_ms_alone",
                                     "mamba_recurrence_share", "kernels")},
             "peak_memory_gb": peak}))
    # 5h's mesh runs, beside each kernel's other paths
    for row in rows:
        for path, counts in mesh_launches.items():
            if counts.get(row["name"]):
                row["launches_by_path"][path] = counts[row["name"]]
                row["launches"] += counts[row["name"]]
    phase_done("7 (launch floor, kernels at the paths' shapes)", t_phase)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
