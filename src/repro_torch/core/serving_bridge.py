# Port of repro/core/serving_bridge.py: the same numpy code, imports rewritten to repro_torch.
"""Batch/queue-aware serving bridge: continuous batching inside the
cluster simulator.

The job-level simulator treats a job as an opaque duration — ``exec_time``
seconds of exclusive worker occupancy.  Real inference engines
(``repro.serving.engine.InferenceEngine``) serve *batched* traffic: a
prefill pass admits a request into the running batch, per-token decode
steps serve every batch member together, and the batch is bounded by the
KV-cache bytes that fit next to the weights.  This module is the bridge
between the two: a token-level request model plus the profile math behind
``repro.core.simulator.BatchedWorkerSim``, the continuous-batching service
model selected with ``Simulator(..., serving="batched")``.

Model (see ``docs/serving_bridge.md`` for the full design note):

* **Requests** — ``repro.core.job.Request`` carries a job's total prompt
  and decode token counts.  ``repro.core.workload.attach_requests``
  Pareto-samples them around each engine's profiled per-query shape.
* **Rates from the ConfigDict** — each ``Entry`` stores ``qps`` and
  ``decode_frac`` (share of query time spent in per-token decode), so the
  solo token rates are ``prefill_rate = prefill_len * qps / (1 - df)`` and
  ``decode_rate = decode_len * qps / df``.  A job with the engine-default
  token counts therefore takes exactly ``exec_time(entry, queries)``
  seconds when served alone — job-level and token-level modes agree at
  batch size 1.
* **Continuous batching** — a batch of ``b`` same-engine jobs drains each
  member at multiplier ``m(b) = 1 / (1 + alpha * (b - 1))`` of its solo
  rate, i.e. aggregate throughput ``b * m(b)`` grows sublinearly with
  ``alpha`` taken from the entry's profiled bottleneck (memory-bound
  decode batches almost for free; compute-bound engines pay more).
* **Batch formation** — a worker admits a job iff the batch is empty or
  (same engine) and (``len(batch) < max_batch``) and one more microbatch
  KV cache fits: ``kv_limit = floor((hbm / 1.2 - weights) / kv_bytes)``,
  the analytic counterpart of ``InferenceEngine.cache_footprint`` built
  from ``repro.core.perfmodel.profile_engine``.

The simulator re-estimates every member's completion on each batch change
and feeds the new times through the event heap; schedulers see the batch
through ``Cluster.depth_penalty`` (queue-depth-adjusted latency,
``1 + alpha * b`` for joining a batch of ``b``) and ``Cluster.admit_ok``
(same-engine / slot / KV eligibility — and, under prefill/decode-
disaggregated pools, the phase-role match).  The prefill/decode split
also powers the streaming-QoS view (per-request TTFT/TPOT with
``Request.ttft_qos`` / ``tpot_qos`` deadlines) and the disaggregated
handoff cost (``kv_transfer_s``); design note ``docs/serving_bridge.md``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

from repro_torch.core.configdict import Entry
from repro_torch.core.engines import EngineSpec
from repro_torch.core.job import Request, exec_time
from repro_torch.core.perfmodel import HBM_UTIL, profile_engine
from repro_torch.core.workers import WorkerPool

# batching efficiency per profiled bottleneck: the marginal cost ``alpha``
# of one extra batch member, relative to its solo service rate.  Decode on
# a memory-bound engine streams the same weights for every member, so an
# extra member is nearly free; compute-bound engines pay close to the
# member's full FLOP cost.
BATCH_ALPHA = {"memory": 0.15, "collective": 0.35, "compute": 0.6}
DEFAULT_ALPHA = 0.5

# prefill->decode KV handoff link for disaggregated pools (pool roles in
# ``repro.core.workers.WorkerPool.role``): an edge<->cloud datacenter link,
# far slower than on-package HBM but wide enough that steady-state cache
# streaming overlaps decode.
DISAGG_XFER_GBPS = 10e9        # bytes/s
DISAGG_XFER_LAT_S = 0.005      # one-way link latency


def batch_multiplier(alpha: float, b: int) -> float:
    """Per-member service-rate multiplier at batch size ``b`` (solo = 1)."""
    if b <= 1:
        return 1.0
    return 1.0 / (1.0 + alpha * (b - 1))


def batch_throughput(alpha: float, b: int) -> float:
    """Aggregate batch throughput in units of one solo stream."""
    return b * batch_multiplier(alpha, b)


def default_request(spec: EngineSpec, queries: int) -> Request:
    """The engine-default token counts for a job of ``queries`` queries."""
    return Request(queries * spec.prefill_len, queries * spec.decode_len)


_profile = functools.lru_cache(maxsize=None)(profile_engine)


def decode_fraction(entry: Entry) -> float:
    """Entry.decode_frac clamped away from 0/1 so both token rates stay
    finite (degenerate all-prefill / all-decode profiles)."""
    return min(max(entry.decode_frac, 0.05), 0.95)


def prefill_prefix(entry: Entry, queries: int) -> float:
    """Solo seconds to the first decoded token for ``queries`` queries at
    the engine-default token counts: the admission + prefill share of
    ``exec_time``.  The single scalar source for every TTFT estimate
    (job-mode metrics, speculation, SLO-MAEL planning); the vectorized
    counterparts are ``job.streaming_threshold`` and
    ``estimator.phase_split_matrices``."""
    full = exec_time(entry, queries)
    return min(full, entry.preproc_s + (queries / entry.qps)
               * (1.0 - decode_fraction(entry)))


@dataclasses.dataclass(frozen=True)
class BatchProfile:
    """Per-(entry, engine, pool) serving rates and batch budgets."""

    prefill_rate: float     # prompt tokens / s, job served alone
    decode_rate: float      # decode tokens / s, job served alone
    kv_limit: int           # max concurrent jobs by KV-cache bytes
    kv_job_bytes: float     # one microbatch cache (per in-flight job)
    alpha: float            # marginal batching cost (bottleneck-derived)


@functools.lru_cache(maxsize=None)
def batch_profile(entry: Entry, spec: EngineSpec,
                  pool: WorkerPool) -> BatchProfile:
    """Token rates + batch budgets for one (engine, worker) deployment.

    Rates are calibrated so the engine-default token counts reproduce the
    profiled ``exec_time`` exactly; the KV budget mirrors the feasibility
    check in ``repro.core.perfmodel.estimate`` (weights + caches + 20%
    activation headroom must fit the replica's HBM).
    """
    df = decode_fraction(entry)
    prefill_rate = spec.prefill_len * entry.qps / (1.0 - df)
    decode_rate = spec.decode_len * entry.qps / df
    prof = _profile(spec)
    budget = entry.chips_per_replica * pool.chip_hbm_bytes * HBM_UTIL
    free = budget / 1.2 - prof.weights_bytes
    if prof.kv_bytes > 0:
        kv_limit = max(1, int(free // prof.kv_bytes))
    else:
        kv_limit = 1 << 30
    alpha = BATCH_ALPHA.get(entry.bottleneck, DEFAULT_ALPHA)
    return BatchProfile(prefill_rate, decode_rate, kv_limit,
                        prof.kv_bytes, alpha)


def solo_service(entry: Entry, prof: BatchProfile,
                 request: Optional[Request], queries: int):
    """(work_s, prefill_s): a job's total solo service seconds, and the
    prefix of that spent in admission + prefill (the rest is per-token
    decode).

    Without a ``Request`` the total is ``exec_time(entry, queries)``
    bit-for-bit, so forcing ``max_batch=1`` reproduces the job-level
    simulator exactly.  With a ``Request`` the token counts modulate the
    service time through the calibrated rates.
    """
    if request is None:
        return exec_time(entry, queries), prefill_prefix(entry, queries)
    prefill = entry.preproc_s + request.prompt_tokens / prof.prefill_rate
    return prefill + request.decode_tokens / prof.decode_rate, prefill


def kv_transfer_s(prof: BatchProfile) -> float:
    """Prefill -> decode handoff delay for one job under disaggregated
    pools: one microbatch KV cache (``prof.kv_job_bytes``, from
    ``perfmodel.profile_engine``) over the disaggregation link.  That is
    the pipeline-fill cost — later microbatches stream while earlier ones
    decode, so the job pays the link once, not per query.

    The staging is *pull-style*: the cache is parked on the prefill pool
    until the decode placement is known, and the decode pool pulls it at
    admission — so a decode leg that lands back on the same
    ``role="both"`` pool pays nothing (the cache never moves), and a
    prefill-pool failure before the pull loses the parked cache (the job
    re-prefills).  The simulator charges this delay as the head of the
    decode member's service."""
    return DISAGG_XFER_LAT_S + prof.kv_job_bytes / DISAGG_XFER_GBPS


def kv_region_transfer_s(prof: BatchProfile) -> float:
    """``kv_transfer_s`` over the inter-region WAN link instead of the
    in-region disaggregation fabric: what a decode leg pays when it lands
    in a *different region* than its prefill pool."""
    from repro_torch.core.constants import REGION_XFER_GBPS, REGION_XFER_LAT_S
    return REGION_XFER_LAT_S + prof.kv_job_bytes / REGION_XFER_GBPS


def region_xfer_extra_s(prof: BatchProfile) -> float:
    """The WAN surcharge on a cross-region KV handoff: the inter-region
    transfer minus the in-region one already charged at admission (never
    negative — the WAN link is strictly worse on both axes)."""
    return max(0.0, kv_region_transfer_s(prof) - kv_transfer_s(prof))


def region_transfer_s(payload_bytes: float) -> float:
    """Seconds to ship ``payload_bytes`` over the inter-region link —
    the REGION_XFER model behind cross-region *placement* (a spilled job's
    input leaves its staged region)."""
    from repro_torch.core.constants import REGION_XFER_GBPS, REGION_XFER_LAT_S
    return REGION_XFER_LAT_S + payload_bytes / REGION_XFER_GBPS


def job_region_xfer_s(job, engines: Optional[dict] = None) -> float:
    """Cross-region input-shipping cost for one job: its prompt tokens
    (the ``Request`` when present, else the engine-default shape) at
    ``TOKEN_BYTES`` each over the REGION_XFER link.  Decode legs of
    disaggregated jobs ship KV instead (``region_xfer_extra_s``, charged
    by the simulator at decode admission) — don't charge both."""
    from repro_torch.core.constants import TOKEN_BYTES
    if job.request is not None:
        tokens = job.request.prompt_tokens
    else:
        if engines is None:
            from repro_torch.core.engines import engine_catalogue
            engines = engine_catalogue()
        spec = engines.get(job.engine)
        tokens = job.queries * spec.prefill_len if spec is not None else 0
    return region_transfer_s(tokens * TOKEN_BYTES)


def batch_stats(cluster) -> Dict[str, Dict[str, float]]:
    """Per-worker serving-bridge stats for demos and benchmarks."""
    from repro_torch.core.simulator import BatchedWorkerSim
    out: Dict[str, Dict[str, float]] = {}
    for name, ws in cluster.workers.items():
        if isinstance(ws, BatchedWorkerSim) and ws.admitted:
            out[name] = {
                "admitted": ws.admitted,
                "peak_batch": ws.peak_batch,
                "prefill_tokens": ws.prefill_tokens,
                "decoded_tokens": ws.decoded_tokens,
                "abandoned": ws.abandoned,
            }
    return out


def __getattr__(name):
    # BatchedWorkerSim lives next to WorkerSim in repro_torch.core.simulator (the
    # simulator imports this module's math at load time, so the class
    # can't live here without an import cycle); re-export it lazily so
    # ``from repro_torch.core.serving_bridge import BatchedWorkerSim`` works.
    if name in ("BatchedWorkerSim", "_InFlight"):
        from repro_torch.core import simulator
        return getattr(simulator, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
