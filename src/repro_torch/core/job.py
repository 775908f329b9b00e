# Port of repro/core/job.py: the same numpy code, imports rewritten to repro_torch.
"""Inference jobs + workload generation (paper §5.1).

Each experiment = 24 jobs over the engine catalogue; Poisson arrivals; QoS
demands from the execution-time distribution of the characterization:
DL (demand-low) = median, DH (demand-high) = 25%-ile; arrival frequency
FL = 1/median, FH = 1/25%-ile.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.configdict import ConfigDict
from repro_torch.core.engines import EngineSpec, default_engines

DEFAULT_QUERIES = 1000


@dataclasses.dataclass(frozen=True)
class Request:
    """Token-level view of a job's traffic, used by the batched serving
    bridge (``repro.core.serving_bridge``): total prompt tokens to prefill
    and total tokens to decode across all of the job's queries.  Jobs
    without a ``Request`` fall back to the engine's profiled per-query
    shape, which makes the token-level service time identical to the
    job-level ``exec_time``.

    ``ttft_qos`` / ``tpot_qos`` are the streaming SLOs (PerLLM-style,
    arXiv:2405.14636): allowed seconds from submission to the first
    decoded token, and allowed seconds per decoded token after the first.
    ``None`` means the job carries no streaming deadline — only the
    end-to-end ``Job.t_qos`` applies, exactly as before the split."""

    prompt_tokens: int
    decode_tokens: int
    ttft_qos: Optional[float] = None    # arrival -> first token budget (s)
    tpot_qos: Optional[float] = None    # per-decoded-token budget (s/tok)


@dataclasses.dataclass
class Job:
    id: int
    engine: str
    queries: int
    t_qos: float                  # allowed seconds from submission
    arrival: float                # submission time
    request: Optional[Request] = None   # token counts (batched serving)
    tenant: str = ""              # traffic class (``TenantSpec.name``)
    # --- overload-control knobs (all inert by default) ---
    # ``patience``: absolute seconds of queueing the client tolerates
    # before hanging up (terminal ``outcome="abandoned"``).  ``None``
    # means the client waits forever, exactly the historical behavior.
    patience: Optional[float] = None
    # ``retry_budget``: per-job override of the simulator-level retry
    # budget — the number of failure-driven re-executions allowed before
    # the job is terminally ``outcome="failed"``.  ``None`` defers to
    # ``Simulator(retry_budget=...)``; when both are ``None`` failures
    # requeue instantly and forever (historical behavior).
    retry_budget: Optional[int] = None


def exec_time(entry, queries: int) -> float:
    """T_estimated per Eq. 2: preproc + q / QPS."""
    return entry.preproc_s + queries / entry.qps


def exec_time_distribution(cd: ConfigDict, queries: int = DEFAULT_QUERIES,
                           engine: Optional[str] = None) -> np.ndarray:
    """Execution times across all configurations and workers (paper §5.1)."""
    pre, qps, _ = _dist_arrays(cd, engine)
    return pre + queries / qps


def _dist_arrays(cd: ConfigDict, engine: Optional[str]):
    # (preproc, qps, decode_frac) vectors over the feasible DSE table rows,
    # cached on the ConfigDict: workload generators call this once per
    # *job* at fleet scale, so the per-call table scan has to go.
    cache = cd.__dict__.setdefault("_dist_cache", {})
    arr = cache.get(engine)
    if arr is None:
        ents = [e for e in cd.table
                if e.qps > 0 and (engine is None or e.engine == engine)]
        arr = cache[engine] = (np.array([e.preproc_s for e in ents]),
                               np.array([e.qps for e in ents]),
                               np.clip([e.decode_frac for e in ents],
                                       0.05, 0.95))
    return arr


def qos_threshold(cd: ConfigDict, engine: str, queries: int,
                  pct: float) -> float:
    """QoS demand for an engine at a given query count: the pct-percentile
    of its execution-time distribution (paper §5.1, DL=50 / DH=25,
    generalized to arbitrary job sizes for the fleet-scale workloads)."""
    return float(np.percentile(exec_time_distribution(cd, queries, engine),
                               pct))


def streaming_threshold(cd: ConfigDict, engine: str, queries: int,
                        pct: float, engines=None):
    """(ttft_s, tpot_s): streaming-QoS analogue of ``qos_threshold``.

    The pct-percentile, over the engine's feasible configurations, of the
    solo prefill-prefix time (``preproc + (q/qps) * (1 - decode_frac)`` —
    the time to the first decoded token when served alone) and of the
    per-output-token decode time (``decode_frac / (qps * decode_len)``,
    independent of the job size).  Workload generators scale these into
    per-class TTFT/TPOT deadlines (``TenantSpec.ttft_scale`` /
    ``tpot_scale``); like ``t_qos``, the thresholds cover service only, so
    queueing eats into the same budget."""
    engines = engines or default_engines()
    pre, qps, df = _dist_arrays(cd, engine)
    ttft = np.percentile(pre + (queries / qps) * (1.0 - df), pct)
    tpot = np.percentile(df / (qps * engines[engine].decode_len), pct)
    return float(ttft), float(tpot)


def make_experiment(cd: ConfigDict, demand: str, freq: str,
                    n_jobs: int = 24, queries: int = DEFAULT_QUERIES,
                    seed: int = 0,
                    engines: Optional[Dict[str, EngineSpec]] = None,
                    intensity: float = 4.0) -> List[Job]:
    """Build a DL-FL / DL-FH / DH-FH job set (paper-fidelity wrapper; the
    general fleet-scale generators live in ``repro.core.workload``)."""
    assert demand in ("DL", "DH") and freq in ("FL", "FH")
    engines = engines or default_engines()
    rng = np.random.default_rng(seed)
    names = list(engines)
    # demands per engine: median (DL) / 25%-ile (DH) of its exec-time dist
    pct = 50 if demand == "DL" else 25
    t_qos = {name: qos_threshold(cd, name, queries, pct) for name in names}
    # arrival rate from the aggregate distribution (paper §5.1: lambda from
    # the median / 25%-ile of execution times over all configs and workers)
    all_dist = exec_time_distribution(cd, queries)
    mean_gap = float(np.percentile(all_dist, 50 if freq == "FL" else 25))
    # the fleet serves W jobs in parallel; ``intensity`` calibrates the
    # utilization to the paper's 3-worker testbed regime
    mean_gap /= intensity
    gaps = rng.exponential(mean_gap, size=n_jobs)
    gaps[0] = 0.0
    arrivals = np.cumsum(gaps)
    jobs = []
    for i in range(n_jobs):
        name = names[i % len(names)]
        jobs.append(Job(i, name, queries, t_qos[name], float(arrivals[i])))
    rng.shuffle(jobs)
    for i, j in enumerate(sorted(jobs, key=lambda j: j.arrival)):
        j.id = i
    return sorted(jobs, key=lambda j: j.arrival)
