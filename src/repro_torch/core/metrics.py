# Port of repro/core/metrics.py: the same numpy code, imports rewritten to repro_torch.
"""Evaluation metrics (paper §5.1): violations, waiting, end-to-end,
excess time, tail latency, scheduling overhead, energy, placement — plus
the streaming-QoS view (TTFT/TPOT averages, tails and deadline misses),
the terminal-outcome taxonomy with goodput (docs/robustness.md), and
per-tenant breakdowns."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.simulator import Cluster, JobResult

#: every terminal state a job can reach (JobResult.outcome refined by
#: ``outcome_of`` — served results carry ``""`` and split into
#: completed/violated by the QoS check)
OUTCOMES = ("completed", "violated", "shed", "abandoned", "failed")


def outcome_of(r: JobResult) -> str:
    """The result's place in the terminal-outcome taxonomy: a non-served
    result reports its own outcome (``shed`` / ``abandoned`` /
    ``failed``), a served one refines into ``completed`` or
    ``violated``."""
    return r.outcome if r.outcome else (
        "violated" if r.violated else "completed")


def summarize(results: Sequence[JobResult]) -> Dict[str, float]:
    # shed/abandoned/failed jobs were never served: latency statistics
    # cover the served results only (bit-identical to the historical
    # summary when every job was served)
    served = [r for r in results if not r.outcome]
    counts = {o: 0 for o in OUTCOMES}
    for r in results:
        counts[outcome_of(r)] += 1
    e2e = np.array([r.e2e for r in served] or [0.0])
    waiting = np.array([r.waiting for r in served] or [0.0])
    excess = np.array([r.excess for r in served] or [0.0])
    overhead = np.array([r.overhead_s + r.decision_s for r in served]
                        or [0.0])
    out = {
        "jobs": len(results),
        "violations": counts["violated"],
        "e2e_avg_s": float(e2e.mean()),
        "e2e_min_s": float(e2e.min()),
        "e2e_max_s": float(e2e.max()),
        "e2e_p99_s": float(np.percentile(e2e, 99)),
        "waiting_avg_s": float(waiting.mean()),
        "excess_avg_s": float(excess[excess > 0].mean()
                              if (excess > 0).any() else 0.0),
        "overhead_avg_s": float(overhead.mean()),
        "overhead_median_s": float(np.median(overhead)),
        "overhead_max_s": float(overhead.max()),
        "overhead_p99_s": float(np.percentile(overhead, 99)),
        # streaming QoS: deadline misses count even where the metric
        # itself is NaN-guarded away (a NaN never violates)
        "ttft_violations": sum(r.ttft_violated for r in served),
        "tpot_violations": sum(r.tpot_violated for r in served),
    }
    for o in OUTCOMES:
        out[o] = counts[o]
    # goodput: within-QoS completions per second of trace span — the
    # overload-control headline (shedding trades raw throughput for
    # completions that still mean something to the client)
    if results:
        span = (max(r.end for r in results)
                - min(r.job.arrival for r in results))
        out["goodput_jps"] = (counts["completed"] / span
                              if span > 0 else 0.0)
    else:
        out["goodput_jps"] = 0.0
    ttft = np.array([r.ttft for r in served] or [np.inf])
    tpot = np.array([r.tpot for r in served] or [np.inf])
    if np.isfinite(ttft).any():
        t = ttft[np.isfinite(ttft)]
        out["ttft_avg_s"] = float(t.mean())
        out["ttft_p99_s"] = float(np.percentile(t, 99))
    if np.isfinite(tpot).any():
        t = tpot[np.isfinite(tpot)]
        out["tpot_avg_s"] = float(t.mean())
        out["tpot_p99_s"] = float(np.percentile(t, 99))
    return out


def summarize_by_tenant(results: Sequence[JobResult]
                        ) -> Dict[str, Dict[str, float]]:
    """Per-traffic-class ``summarize`` keyed by ``Job.tenant`` (jobs from
    hand-built lists land under ``""``)."""
    groups: Dict[str, List[JobResult]] = {}
    for r in results:
        groups.setdefault(r.job.tenant, []).append(r)
    return {name: summarize(rs) for name, rs in sorted(groups.items())}


def placement(results: Sequence[JobResult]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in results:
        if not r.worker:        # shed/abandoned/failed: never placed
            continue
        out[r.worker] = out.get(r.worker, 0) + 1
    total = sum(out.values())
    return {w: c / total for w, c in sorted(out.items())}


def energy_by_pool(cluster: Cluster) -> Dict[str, float]:
    return {name: ws.energy_j for name, ws in cluster.workers.items()}
