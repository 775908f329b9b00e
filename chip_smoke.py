#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, the PyTorch version; build both CUDA
   sources from ``src/repro_torch/kernels/csrc`` in parallel (one ``nvcc``
   each) and time the build;
2. each kernel against its plain PyTorch version on the card, exactly
   (every output, NaN matched by position), with the kernel's, the plain
   version's and the byte bound's milliseconds:
   (a) the v1 and v2 scoring kernels at (J, W) = (2048, 256), (2043, 256),
       (10000, 64) and (16384, 2048) on messy inputs;
   (b) the device-resident tick (``tick_score_kernel``, the sort,
       ``greedy_place_kernel``) at (J, cap, W) = (2043, 4096, 256),
       (10000, 16384, 64) and (16384, 32768, 2048), energy off and on: inf
       rows and columns, slot -1 padding, doomed rows, f32 ties, NaN, ±inf
       and -0.0 urgencies, K > 1 admission masks;
3. the main path at full size, on the 10,000-job MMPP scenario over the
   64-pool fleet ``synth_fleet(8, 28, 28)``: (a) job mode through v1,
   (b) batched with streaming deadlines through v2, and the device-resident
   tick (c) in job mode, (d) batched with streaming deadlines and
   ``energy_weight=0.5``, (e) under ``HierarchicalSynergAI`` over three
   regions of the same fleet on ``regional_scenario``.  Each run counts its
   kernel launches (the counts set to 0 just before it), must give the same
   ``JobResult``s as the same run on the CPU, and is set beside the default
   numpy ``SynergAI()``; the resident runs also print their per-tick
   transfer counters, and one more job-mode resident run over the first
   3,000 jobs times the stages of a device tick;
4. the kernels again at the main path's mean shape, one JSON line with each
   kernel's launches and times, then the card's line from ``nvidia-smi``,
   then the result.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPES = ((2048, 256), (2043, 256), (10000, 64), (16384, 2048))
TICK_SHAPES = ((2043, 4096, 256), (10000, 16384, 64), (16384, 32768, 2048))
SOURCES = ("scheduler_score", "scheduler_tick")
N_JOBS = 10_000
POOLS = (8, 28, 28)
REPS = 25                 # timed samples per kernel (median reported)
BATCH = 10                # launches per timed sample
TIMES = ("ms", "device_ms", "plain_ms", "bound_ms")

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


def device_ms(fn, kernel_name, reps=REPS):
    """Mean device time of the CUDA kernel named ``kernel_name`` over
    ``reps`` calls of ``fn``, from the profiler's trace (None if the trace
    holds no device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if kernel_name in evt.key and total and evt.count:
            return total / evt.count / 1e3
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
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.compile_source, SOURCES))
    for source in SOURCES:
        _build.load(source)
    print(f"build: {', '.join(f'{s}.cu' for s in SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for source in SOURCES:
        for line in _build.build_log.get(source, "").splitlines():
            if "registers" in line or "Compiling" in line:
                print("  ptxas " + line.strip())

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

    # 3. the main path at full size
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

    # 4. the kernels at the main path's mean shape, and the result
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
