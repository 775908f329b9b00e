#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and hold its
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit, the PyTorch version; build the kernels
   from ``src/repro_torch/kernels/csrc`` and time the build;
2. each kernel against its plain PyTorch version on the card, exactly
   (every output, NaN matched by position), at (J, W) = (2048, 256),
   (2043, 256), (10000, 64) and (16384, 2048) on messy inputs, with the
   kernel's, the plain version's and the byte bound's milliseconds;
3. the main path at full size: SynergAI on the 10,000-job MMPP scenario over
   the 64-pool fleet ``synth_fleet(8, 28, 28)``, (a) in job mode through v1
   and (b) batched with streaming deadlines through v2.  Each run counts
   its kernel launches, must give the same ``JobResult``s as the same run on
   the CPU, and is set beside the default numpy ``SynergAI()``;
4. one JSON line with each kernel's launches and times at the main path's
   mean shape, then the card's line from ``nvidia-smi``, then the result.

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

import numpy as np

ROOT = Path(__file__).resolve().parent
SHAPES = ((2048, 256), (2043, 256), (10000, 64), (16384, 2048))
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


def time_ms(fn) -> float:
    """Median over REPS samples of one call's device time, each sample
    timed with CUDA events around BATCH back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / BATCH)
    return statistics.median(samples)


def device_ms(fn, kernel_name):
    """Mean device time of the CUDA kernel named ``kernel_name`` over REPS
    calls of ``fn``, from the profiler's trace (None if the trace holds no
    device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
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


def hold_kernel(name, wrapper, plain, inputs, nbytes, rate, kernel_name):
    """Run ``wrapper`` (the kernel) and ``plain`` on the same card inputs,
    fail unless every output is identical, and time both: ``ms`` and
    ``plain_ms`` per call with CUDA events (host overhead included where
    it exceeds the device time), ``device_ms`` the kernel alone."""
    import torch
    out = wrapper(*inputs)
    ref = plain(*inputs)
    torch.cuda.synchronize()
    ok = all(exact(a, b) for a, b in zip(out, ref))
    err = max_abs_err(out, ref)
    if not ok:
        raise SystemExit(f"FAIL {name}: kernel and plain version differ "
                         f"(max abs err {err})")
    ms = time_ms(lambda: wrapper(*inputs))
    plain_ms = time_ms(lambda: plain(*inputs))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms(lambda: wrapper(*inputs), kernel_name),
            "bound_ms": nbytes / rate * 1e3}


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


def drive(cd, jobs, fleet, serving, score_fn):
    """One simulator run; returns (results, per-tick schedule seconds,
    wall seconds)."""
    from repro_torch.core.scheduler import SynergAI
    from repro_torch.core.simulator import Simulator
    policy = SynergAI(score_fn=score_fn)
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


def main_path_run(label, cd, fleet, serving, streaming, v2, kernel):
    from repro_torch.core.metrics import summarize
    from repro_torch.core.scoring import make_torch_score_fn
    from repro_torch.core.workload import scenario
    jobs = scenario(cd, "mmpp", n_jobs=N_JOBS, fleet=fleet, seed=0,
                    serving=serving, streaming=streaming)
    res_np, ticks_np, wall_np = drive(cd, jobs, fleet, serving, None)

    card_fn = make_torch_score_fn(v2=v2)
    kernel.launches = 0
    res_card, ticks_card, wall_card = drive(cd, jobs, fleet, serving,
                                            card_fn)
    launches = kernel.launches

    cpu_fn = make_torch_score_fn(v2=v2, device="cpu")
    res_cpu, _, wall_cpu = drive(cd, jobs, fleet, serving, cpu_fn)
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
    from repro_torch.core.offline import characterize
    from repro_torch.core.workers import synth_fleet
    from repro_torch.kernels import _build
    from repro_torch.kernels import scheduler_score as ss

    # 1. the card, the build
    resolve_device()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = next((r for key, r in HBM_RATE if key in name), 3.35e12)
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; HBM rate {rate / 1e12} TB/s", flush=True)
    t0 = time.perf_counter()
    _build.load("scheduler_score")
    print(f"build: scheduler_score.cu in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in _build.build_log.get("scheduler_score", "").splitlines():
        if "registers" in line or "Compiling" in line:
            print("  ptxas " + line.strip())

    # 2. each kernel against its plain version at the stated shapes
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
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
