# Port of repro/core/workload.py: the same numpy code, imports rewritten to repro_torch.
"""Fleet-scale workload subsystem: composable arrival processes, heavy-tail
query sizes, multi-tenant mixes, and synthetic failure traces.

The paper's evaluation (§5.1) uses 24-job Poisson experiments on a 3-worker
testbed — that stays in ``repro.core.job.make_experiment``, the
paper-fidelity wrapper.  This module generates the large, bursty, diverse
traces (PerLLM-style: arXiv:2405.14636) that the event-heap simulator and
the ``synth_fleet`` clusters are built for:

* ``PoissonArrivals``      — homogeneous baseline.
* ``MMPPArrivals``         — Markov-modulated Poisson: bursty at equal mean
                             rate (dispersion index > 1).
* ``DiurnalArrivals``      — sinusoidal non-homogeneous Poisson (thinning).
* ``FlashCrowdArrivals``   — a spike window at ``spike_factor`` x the base.
* ``DriftedArrivals``      — engine-popularity drift: a base arrival
  process plus time-varying engine mix weights (smooth or piecewise,
  re-normalized per window), so the offline-profiled traffic mix goes
  stale mid-trace.
* ``ParetoSize``           — heavy-tail query counts.
* ``TenantSpec`` + ``make_workload`` — multi-tenant mixes over the engine
  catalogue with per-tenant QoS tightness.
* ``scenario``             — named presets used by tests and benchmarks.
* ``attach_requests``      — token-level ``Request`` annotations (prompt /
  decode token counts, Pareto-sampled around each engine's profiled
  per-query shape) for the batched serving bridge; every preset also runs
  token-level via ``scenario(..., serving="batched")``.  Tenants with
  ``ttft_scale`` / ``tpot_scale`` additionally get per-class streaming
  SLOs (``Request.ttft_qos`` / ``tpot_qos``;
  ``scenario(..., streaming=...)`` is the all-tenants shorthand).
* ``save_trace`` / ``load_trace`` / ``replay`` — JSON-lines serving
  traces: any job list (or completed ``Simulator`` run) exports to a
  trace file that round-trips exactly, so replays are bit-for-bit.
* ``synth_failures``       — Poisson worker failures / exponential repair;
  ``regions=`` + ``correlation=`` group pools into regions with
  correlated outage windows (one event downs a sampled fraction of a
  region simultaneously — shared-infrastructure edge outages);
  ``flap=`` splits every outage into crash-restart pulses (flapping
  pools, the retry-budget stress case).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.configdict import ConfigDict
from repro_torch.core.engines import default_engines
from repro_torch.core.job import (DEFAULT_QUERIES, Job, Request, exec_time,
                            qos_threshold, streaming_threshold)
from repro_torch.core.simulator import DegradationEvent, FailureEvent
from repro_torch.core.workers import WorkerPool


# ---------------------------------------------------------------------------
# arrival processes


class ArrivalProcess:
    """Generates ``n`` sorted arrival times (seconds) from an rng."""

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError

    def mean_rate(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class PoissonArrivals(ArrivalProcess):
    rate: float                                   # jobs / second

    def sample(self, rng, n):
        return np.cumsum(rng.exponential(1.0 / self.rate, size=n))

    def mean_rate(self):
        return self.rate


@dataclasses.dataclass
class MMPPArrivals(ArrivalProcess):
    """Markov-modulated Poisson process: a continuous-time chain cycles
    through ``rates`` states with exponential dwell times ``dwell_s``.
    Exact simulation — the exponential's memorylessness lets us redraw the
    inter-arrival gap whenever a state switch interrupts it."""

    rates: Sequence[float]
    dwell_s: Sequence[float]

    def sample(self, rng, n):
        assert len(self.rates) == len(self.dwell_s) >= 2
        times = np.empty(n)
        state, t, i = 0, 0.0, 0
        switch = t + rng.exponential(self.dwell_s[0])
        while i < n:
            gap = rng.exponential(1.0 / self.rates[state])
            if t + gap >= switch:
                t = switch
                state = (state + 1) % len(self.rates)
                switch = t + rng.exponential(self.dwell_s[state])
                continue
            t += gap
            times[i] = t
            i += 1
        return times

    def mean_rate(self):                          # time-weighted
        r = np.asarray(self.rates, float)
        d = np.asarray(self.dwell_s, float)
        return float((r * d).sum() / d.sum())


class _ThinnedArrivals(ArrivalProcess):
    """Non-homogeneous Poisson via Lewis-Shedler thinning."""

    def rate_at(self, t: float) -> float:
        raise NotImplementedError

    def max_rate(self) -> float:
        raise NotImplementedError

    def sample(self, rng, n):
        lam = self.max_rate()
        times = np.empty(n)
        t, i = 0.0, 0
        while i < n:
            t += rng.exponential(1.0 / lam)
            if rng.random() * lam <= self.rate_at(t):
                times[i] = t
                i += 1
        return times


@dataclasses.dataclass
class DiurnalArrivals(_ThinnedArrivals):
    """rate(t) = base * (1 + amplitude * sin(2 pi t / period))."""

    base_rate: float
    amplitude: float = 0.8                        # in [0, 1)
    period_s: float = 3600.0

    def rate_at(self, t):
        return self.base_rate * (
            1.0 + self.amplitude * np.sin(2.0 * np.pi * t / self.period_s))

    def max_rate(self):
        return self.base_rate * (1.0 + abs(self.amplitude))

    def mean_rate(self):
        return self.base_rate


@dataclasses.dataclass
class CarbonTrace:
    """Per-region diurnal grid carbon-intensity curves (gCO2eq/kWh).

    ``intensity(region, t) = base[region] * (1 + amplitude *
    sin(2 pi (t + phase_s[region]) / period_s))`` — attach to a
    region-tagged fleet (``synth_fleet(..., regions=k)``) and hand the
    trace to ``SynergAI(energy_weight=..., carbon=...)`` /
    ``HierarchicalSynergAI``: regions differ in mean grid mix (``base``)
    *and* in diurnal phase, so the carbon-optimal region moves over the
    trace (solar noon walks around the globe).  Unknown regions (e.g. the
    untagged ``""``) read ``default_g``, flat.
    """

    base: Dict[str, float]             # region -> mean gCO2eq/kWh
    amplitude: float = 0.5             # in [0, 1)
    period_s: float = 86400.0          # diurnal by default
    phase_s: Optional[Dict[str, float]] = None   # region -> offset seconds
    default_g: float = 400.0           # intensity of unknown regions

    def intensity(self, region: str, t: float) -> float:
        base = self.base.get(region)
        if base is None:
            return self.default_g
        off = (self.phase_s or {}).get(region, 0.0)
        return base * (1.0 + self.amplitude
                       * math.sin(2.0 * math.pi * (t + off) / self.period_s))

    def mean_intensity(self) -> float:
        """Across-region mean of the per-region means (the sinusoid
        integrates to zero over a period) — the normalization behind
        ``relative``."""
        if not self.base:
            return self.default_g
        return sum(self.base.values()) / len(self.base)

    def relative(self, region: str, t: float) -> float:
        """Dimensionless intensity (1.0 == fleet-mean grid): what scales
        the scheduler's energy term into a carbon term without changing
        ``energy_weight``'s seconds-per-joule units."""
        m = self.mean_intensity()
        return self.intensity(region, t) / m if m > 0 else 1.0

    def relative_for(self, regions: Sequence[str], t: float) -> np.ndarray:
        """[W] ``relative`` over a per-worker region list (memoized per
        distinct region — fleets have few regions, many workers)."""
        memo: Dict[str, float] = {}
        out = np.empty(len(regions))
        for i, r in enumerate(regions):
            v = memo.get(r)
            if v is None:
                v = memo[r] = self.relative(r, t)
            out[i] = v
        return out

    def cleanest(self, regions: Sequence[str], t: float) -> str:
        """The region with the lowest intensity at ``t``."""
        return min(regions, key=lambda r: self.intensity(r, t))

    @classmethod
    def synth(cls, regions: Sequence[str], amplitude: float = 0.5,
              period_s: float = 86400.0, lo: float = 250.0,
              hi: float = 700.0) -> "CarbonTrace":
        """A deterministic synthetic grid for k regions: mean intensities
        spread linearly over [lo, hi] and diurnal phases staggered by
        ``period_s / k`` (region i's solar noon lags region i+1's), so
        both the *structurally* cleanest region and the *instantaneously*
        cleanest one are exercised."""
        rs = list(regions)
        k = max(1, len(rs))
        base = {r: lo + (hi - lo) * (i / max(1, k - 1) if k > 1 else 0.0)
                for i, r in enumerate(rs)}
        phase = {r: period_s * i / k for i, r in enumerate(rs)}
        return cls(base=base, amplitude=amplitude, period_s=period_s,
                   phase_s=phase)


@dataclasses.dataclass
class FlashCrowdArrivals(_ThinnedArrivals):
    """Baseline Poisson plus a flash-crowd window at ``spike_factor`` x."""

    base_rate: float
    spike_at: float
    spike_duration: float
    spike_factor: float = 8.0

    def rate_at(self, t):
        in_spike = self.spike_at <= t < self.spike_at + self.spike_duration
        return self.base_rate * (self.spike_factor if in_spike else 1.0)

    def max_rate(self):
        return self.base_rate * self.spike_factor

    def mean_rate(self):
        return self.base_rate                     # spike excluded: lower bound


@dataclasses.dataclass
class DriftedArrivals(ArrivalProcess):
    """Engine-popularity drift: arrival *times* come from ``base``, while
    the engine mix drifts from ``weights_start`` to ``weights_end`` over
    ``span_s`` seconds.  ``make_workload`` picks each job's engine with
    ``weights_at(arrival)`` instead of the tenant's static mix, so the
    offline-profiled traffic mix goes stale mid-trace and the online
    policy has to recover (PerLLM-style service-mix shift,
    arXiv:2405.14636).

    ``mode="smooth"`` interpolates linearly; ``mode="piecewise"`` holds
    the mix constant inside each of ``n_windows`` equal windows and steps
    between them (first window = start mix, last = end mix).  Weights are
    re-normalized per window, so they sum to 1 at every instant whatever
    the inputs' scales.  Weight vectors index the *tenant's* engine list
    (``TenantSpec.engines``); ``engine_weights`` must stay ``None`` —
    the drift carries the mix."""

    base: ArrivalProcess
    weights_start: Sequence[float]
    weights_end: Sequence[float]
    span_s: float
    mode: str = "smooth"
    n_windows: int = 4

    def __post_init__(self):
        if self.mode not in ("smooth", "piecewise"):
            raise ValueError(f"mode must be 'smooth' or 'piecewise', "
                             f"got {self.mode!r}")
        if self.span_s <= 0:
            raise ValueError("span_s must be positive")
        if self.mode == "piecewise" and self.n_windows < 2:
            raise ValueError("piecewise drift needs n_windows >= 2")
        w0 = np.asarray(self.weights_start, float)
        w1 = np.asarray(self.weights_end, float)
        if w0.shape != w1.shape or w0.ndim != 1:
            raise ValueError("weights_start/weights_end must be equal-"
                             "length 1-D vectors")
        if (w0 < 0).any() or (w1 < 0).any() or not (w0.sum() > 0
                                                    and w1.sum() > 0):
            raise ValueError("weights must be non-negative with a "
                             "positive sum")
        # make_workload calls weights_at once per job at fleet scale;
        # normalize the endpoints once here
        self._w0n = w0 / w0.sum()
        self._w1n = w1 / w1.sum()

    def weights_at(self, t: float) -> np.ndarray:
        """Normalized engine mix at time ``t`` (clamped to the drift
        span: before 0 it is the start mix, after ``span_s`` the end)."""
        return self.weights_at_times([t])[0]

    def weights_at_times(self, times) -> np.ndarray:
        """Vectorized ``weights_at``: the ``[len(times), n_engines]``
        mix matrix, one normalized row per instant (the fleet-scale
        path — ``make_workload`` draws every pick from one call)."""
        u = np.clip(np.asarray(times, float) / self.span_s, 0.0, 1.0)
        if self.mode == "piecewise":
            k = np.minimum((u * self.n_windows).astype(int),
                           self.n_windows - 1)
            u = k / (self.n_windows - 1)
        w = (1.0 - u)[:, None] * self._w0n + u[:, None] * self._w1n
        return w / w.sum(axis=1, keepdims=True)

    def sample(self, rng, n):
        return self.base.sample(rng, n)

    def mean_rate(self):
        return self.base.mean_rate()


def index_of_dispersion(times: np.ndarray, window_s: float) -> float:
    """Variance/mean of per-window arrival counts: 1 for Poisson, > 1 for
    bursty processes.  The standard burstiness sanity metric."""
    t = np.asarray(times, float)
    edges = np.arange(0.0, float(t.max()) + window_s, window_s)
    counts, _ = np.histogram(t, edges)
    return float(counts.var() / max(counts.mean(), 1e-12))


# ---------------------------------------------------------------------------
# query-size distributions


class SizeDistribution:
    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class FixedSize(SizeDistribution):
    queries: int = DEFAULT_QUERIES

    def sample(self, rng, n):
        return np.full(n, self.queries, dtype=int)


@dataclasses.dataclass
class ParetoSize(SizeDistribution):
    """Heavy-tail query counts: q = q_min * (1 + Pareto(alpha)), capped."""

    alpha: float = 1.5
    q_min: int = 200
    q_max: int = 20_000

    def sample(self, rng, n):
        q = self.q_min * (1.0 + rng.pareto(self.alpha, size=n))
        return np.minimum(q, self.q_max).astype(int)


# ---------------------------------------------------------------------------
# multi-tenant workloads


@dataclasses.dataclass
class TenantSpec:
    """One traffic class: its own arrival process, engine subset (with
    optional mix weights), size distribution and QoS tightness (percentile
    per paper §5.1: DL=50, DH=25; ``qos_scale`` loosens/tightens the
    budget).

    ``ttft_scale`` / ``tpot_scale`` add per-class *streaming* SLOs
    (``Request.ttft_qos`` / ``tpot_qos``, set by ``attach_requests``):
    each job's deadline is the scale times its engine's
    ``streaming_threshold`` at ``qos_percentile``.  ``None`` (default)
    emits no streaming deadline; batched serving is required to meet (or
    even observe) one."""

    name: str
    arrivals: ArrivalProcess
    n_jobs: int
    engines: Optional[Sequence[str]] = None       # None -> whole catalogue
    engine_weights: Optional[Sequence[float]] = None   # None -> uniform
    sizes: SizeDistribution = dataclasses.field(default_factory=FixedSize)
    qos_percentile: float = 50.0
    qos_scale: float = 1.0
    start_at: float = 0.0
    ttft_scale: Optional[float] = None    # x streaming_threshold ttft
    tpot_scale: Optional[float] = None    # x streaming_threshold tpot
    # client patience as a multiple of each job's QoS budget: a queued
    # job abandons (terminal outcome "abandoned") after
    # ``patience_scale * t_qos`` seconds of waiting.  None (default)
    # waits forever — the historical behaviour.
    patience_scale: Optional[float] = None


def make_workload(cd: ConfigDict, tenants: Sequence[TenantSpec],
                  seed: int = 0) -> List[Job]:
    """Merge all tenants into one arrival-ordered, re-numbered job list."""
    rng = np.random.default_rng(seed)
    jobs: List[Job] = []
    for tenant in tenants:
        names = list(tenant.engines or default_engines())
        drift = (tenant.arrivals
                 if isinstance(tenant.arrivals, DriftedArrivals) else None)
        p = None
        if tenant.engine_weights is not None:
            if drift is not None:
                raise ValueError(
                    f"tenant {tenant.name!r}: a DriftedArrivals tenant "
                    f"carries its mix in the drift weights; leave "
                    f"engine_weights=None")
            p = np.asarray(tenant.engine_weights, float)
            p = p / p.sum()
        arrivals = tenant.start_at + tenant.arrivals.sample(rng,
                                                            tenant.n_jobs)
        queries = tenant.sizes.sample(rng, tenant.n_jobs)
        if drift is not None:
            if len(np.asarray(drift.weights_start)) != len(names):
                raise ValueError(
                    f"tenant {tenant.name!r}: drift weights cover "
                    f"{len(np.asarray(drift.weights_start))} engines, "
                    f"tenant has {len(names)}")
            # per-job mix at the job's arrival (drift clock starts at
            # the tenant's start_at): one inverse-CDF draw per job over
            # the [n_jobs, n_engines] weight matrix
            cdf = np.cumsum(
                drift.weights_at_times(arrivals - tenant.start_at),
                axis=1)
            picks = np.minimum(
                (cdf < rng.random(tenant.n_jobs)[:, None]).sum(axis=1),
                len(names) - 1)
        else:
            picks = rng.choice(len(names), size=tenant.n_jobs, p=p)
        for at, q, ei in zip(arrivals, queries, picks):
            engine = names[int(ei)]
            t_qos = tenant.qos_scale * qos_threshold(
                cd, engine, int(q), tenant.qos_percentile)
            patience = (tenant.patience_scale * float(t_qos)
                        if tenant.patience_scale is not None else None)
            jobs.append(Job(0, engine, int(q), float(t_qos), float(at),
                            tenant=tenant.name, patience=patience))
    jobs.sort(key=lambda j: j.arrival)
    for i, j in enumerate(jobs):
        j.id = i
    return jobs


# ---------------------------------------------------------------------------
# token-level requests (batched serving bridge)


def attach_requests(jobs: Sequence[Job], engines=None, seed: int = 0,
                    alpha: float = 2.5, cd: Optional[ConfigDict] = None,
                    tenants: Optional[Sequence[TenantSpec]] = None
                    ) -> Sequence[Job]:
    """Annotate jobs with token-level ``Request``s for the serving bridge.

    Per-query prompt and decode lengths are Pareto-sampled (via the
    ``ParetoSize`` machinery) around each engine's profiled shape —
    ``q_min = 0.6 * len`` with tail index ``alpha`` has mean ~= the
    profiled length, so the aggregate load matches the job-level
    calibration while individual jobs spread over a heavy-tailed range.
    Jobs are mutated in place (and returned for convenience).

    ``tenants`` + ``cd`` additionally stamp per-class streaming SLOs:
    a job whose ``Job.tenant`` names a spec with ``ttft_scale`` /
    ``tpot_scale`` gets ``Request.ttft_qos`` / ``tpot_qos`` set to the
    scale times its engine's ``streaming_threshold`` at the tenant's
    ``qos_percentile`` (the same construction as ``t_qos``).
    """
    engines = engines or default_engines()
    by_tenant = {t.name: t for t in (tenants or ())}
    if cd is None and any(t.ttft_scale is not None
                          or t.tpot_scale is not None
                          for t in by_tenant.values()):
        raise ValueError("streaming deadlines (ttft_scale/tpot_scale) "
                         "need the ConfigDict: pass cd=...")
    rng = np.random.default_rng(seed)
    by_engine: dict = {}
    for i, j in enumerate(jobs):
        by_engine.setdefault(j.engine, []).append(i)
    for name, idx in sorted(by_engine.items()):
        spec = engines[name]
        p_dist = ParetoSize(alpha, max(1, int(0.6 * spec.prefill_len)),
                            6 * spec.prefill_len)
        d_dist = ParetoSize(alpha, max(1, int(0.6 * spec.decode_len)),
                            6 * spec.decode_len)
        prompts = p_dist.sample(rng, len(idx))
        decodes = d_dist.sample(rng, len(idx))
        thresholds: dict = {}      # (engine, queries, pct) -> (ttft, tpot)
        for i, p, d in zip(idx, prompts, decodes):
            job = jobs[i]
            ttft_qos = tpot_qos = None
            ts = by_tenant.get(job.tenant)
            if ts is not None and (ts.ttft_scale is not None
                                   or ts.tpot_scale is not None):
                key = (job.engine, job.queries, ts.qos_percentile)
                if key not in thresholds:
                    thresholds[key] = streaming_threshold(
                        cd, job.engine, job.queries, ts.qos_percentile,
                        engines)
                ttft_t, tpot_t = thresholds[key]
                if ts.ttft_scale is not None:
                    ttft_qos = ts.ttft_scale * ttft_t
                if ts.tpot_scale is not None:
                    tpot_qos = ts.tpot_scale * tpot_t
            job.request = Request(int(job.queries * p),
                                  int(job.queries * d),
                                  ttft_qos, tpot_qos)
    return jobs


# ---------------------------------------------------------------------------
# scenario presets


def engine_throughput(cd: ConfigDict, fleet: Sequence[WorkerPool],
                      engines: Sequence[str],
                      queries: int = DEFAULT_QUERIES) -> dict:
    """Fleet-wide peak throughput per engine (jobs/s): each pool serves
    1/T_exec jobs per second at its optimal configuration."""
    thr = {}
    for e in engines:
        total = 0.0
        for w in fleet:
            ent = cd.optimal(e, w.name)
            if ent is not None and ent.qps > 0:
                total += 1.0 / exec_time(ent, queries)
        thr[e] = total
    return thr


def fleet_rate(cd: ConfigDict, fleet: Sequence[WorkerPool],
               utilization: float = 0.7,
               engines: Optional[Sequence[str]] = None,
               weights: Optional[Sequence[float]] = None,
               queries: int = DEFAULT_QUERIES) -> float:
    """Arrival rate that drives ``fleet`` to ~``utilization``.

    On a heterogeneous fleet a global median is meaningless: a cloud-only
    236B engine contributes hours of work per job while a 2B edge engine
    contributes seconds.  Each engine's offered work is weighed against its
    *fleet-wide throughput* (sum of 1/T_exec over feasible pools), i.e. the
    utilization the mix induces under throughput-proportional routing.
    Defaults to the capacity-proportional mix used by ``scenario``."""
    engines = list(engines or default_engines())
    thr = engine_throughput(cd, fleet, engines, queries)
    if weights is None:
        weights = [thr[e] for e in engines]       # capacity-proportional
    for e, w in zip(engines, weights):
        if w > 0 and thr[e] <= 0:
            raise ValueError(f"engine {e!r} is infeasible on this fleet")
    wsum = float(sum(weights))
    work = sum(w / wsum / thr[e]
               for e, w in zip(engines, weights) if w > 0)
    return utilization / work


def region_rates(cd: ConfigDict, fleet: Sequence[WorkerPool],
                 utilization: float = 0.7,
                 engines: Optional[Sequence[str]] = None,
                 queries: int = DEFAULT_QUERIES) -> dict:
    """Per-region arrival rates: ``fleet_rate`` over each region's pool
    group of a tagged fleet (``WorkerPool.region``).  Regions differ in
    capacity — and, with archetypes striped round-robin, in *feasible
    engine set* — so one global rate over-drives small regions and idles
    large ones; this is the calibration behind multi-region scenarios
    and the hierarchy router's load picture.  Engines infeasible within
    a region are dropped from that region's mix; a region where nothing
    runs gets rate 0.0.  Untagged fleets collapse to ``{"": rate}``."""
    from repro_torch.core.workers import region_groups
    engines = list(engines or default_engines())
    out = {}
    for r, pools in region_groups(fleet).items():
        thr = engine_throughput(cd, pools, engines, queries)
        feas = [e for e in engines if thr[e] > 0]
        out[r] = (fleet_rate(cd, pools, utilization, feas,
                             queries=queries) if feas else 0.0)
    return out


def regional_scenario(cd: ConfigDict, kind: str, n_jobs: int = 10_000,
                      fleet: Optional[Sequence[WorkerPool]] = None,
                      utilization: float = 0.7, seed: int = 0,
                      serving: str = "job", streaming=None,
                      patience: Optional[float] = None) -> List[Job]:
    """Multi-region traffic for a tagged fleet: one independent
    ``scenario`` stream per region, each calibrated (rate *and* engine
    mix) against that region's own pools, merged by arrival time with
    fresh sequential ids.  Job counts split proportional to the regional
    rates (largest-remainder, so they sum to ``n_jobs`` exactly) and
    each region draws from its own sub-seed.  Untagged or single-region
    fleets fall through to plain ``scenario`` unchanged."""
    from repro_torch.core.workers import default_fleet, region_groups
    fleet = list(fleet if fleet is not None else default_fleet())
    groups = region_groups(fleet)
    if len(groups) <= 1:
        return scenario(cd, kind, n_jobs=n_jobs, fleet=fleet,
                        utilization=utilization, seed=seed,
                        serving=serving, streaming=streaming,
                        patience=patience)
    rates = region_rates(cd, fleet, utilization)
    total = sum(rates.values())
    names = list(groups)
    if total <= 0:
        raise ValueError("no engine is feasible in any region")
    shares = [rates[r] / total for r in names]
    counts = [int(n_jobs * s) for s in shares]
    rema = sorted(range(len(names)),
                  key=lambda i: (counts[i] - n_jobs * shares[i], i))
    for i in range(n_jobs - sum(counts)):
        counts[rema[i % len(names)]] += 1
    jobs: List[Job] = []
    for i, (r, n_r) in enumerate(zip(names, counts)):
        if n_r <= 0:
            continue
        jobs.extend(scenario(cd, kind, n_jobs=n_r, fleet=groups[r],
                             utilization=utilization,
                             seed=seed + 7919 * (i + 1), serving=serving,
                             streaming=streaming, patience=patience))
    jobs.sort(key=lambda j: j.arrival)
    for i, j in enumerate(jobs):
        j.id = i
    return jobs


# engines light enough for edge pools vs the heavyweight cloud set — used
# by the multi-tenant preset to shape per-tenant placement pressure
EDGE_ENGINES = ("danube-1.8b/bf16", "gemma-2b/bf16", "gemma-2b/int8",
                "qwen3-4b/int8", "hymba-1.5b/bf16", "rwkv6-1.6b/bf16")
HEAVY_ENGINES = ("qwen3-32b/bf16", "qwen3-4b/bf16", "phi3.5-moe/bf16",
                 "deepseek-v2/int8", "llama32-vision/bf16",
                 "seamless-m4t/bf16")

SCENARIOS = ("poisson", "mmpp", "diurnal", "flash", "multi-tenant",
             "drift")


def _mix(cd, fleet, engines):
    """Capacity-proportional traffic mix over the feasible engine subset:
    light edge-friendly engines carry most of the traffic, heavyweights
    proportionally less — a fleet mix whose offered load is well-defined."""
    thr = engine_throughput(cd, fleet, engines)
    names = [e for e in engines if thr[e] > 0]
    assert names, "no engine of the mix is feasible on this fleet"
    return names, [thr[e] for e in names]


def scenario(cd: ConfigDict, kind: str, n_jobs: int = 10_000,
             fleet: Optional[Sequence[WorkerPool]] = None,
             utilization: float = 0.7, seed: int = 0,
             serving: str = "job",
             streaming=None,
             patience: Optional[float] = None) -> List[Job]:
    """Named fleet-scale scenarios over the engine catalogue, calibrated to
    ``utilization`` of the given fleet (default: the 3-pool paper fleet).
    ``kind="drift"`` adds engine-popularity drift: the capacity-
    proportional mix slides toward a heavyweight-dominated one over the
    trace (``DriftedArrivals``), so the calibration goes stale.

    ``serving="batched"`` additionally attaches token-level ``Request``
    annotations (see ``attach_requests``) so the trace drives the
    continuous-batching serving bridge — pair it with
    ``Simulator(..., serving="batched")``.

    ``streaming=(ttft_scale, tpot_scale)`` stamps every tenant with those
    streaming-SLO scales (per-class control wants explicit ``TenantSpec``
    + ``make_workload`` + ``attach_requests``); batched serving only.

    ``patience=`` stamps every tenant with that ``patience_scale``: each
    job abandons after ``patience * t_qos`` seconds of queueing
    (``JobResult.outcome == "abandoned"``).  ``None`` (default) waits
    forever — bit-for-bit the historical traces.
    """
    if serving not in ("job", "batched"):
        raise ValueError(f"serving must be 'job' or 'batched', "
                         f"got {serving!r}")
    if streaming is not None and serving != "batched":
        raise ValueError("streaming TTFT/TPOT deadlines ride on the "
                         "token-level Request: use serving='batched'")
    from repro_torch.core.workers import default_fleet
    fleet = list(fleet or default_fleet())
    engines, weights = _mix(cd, fleet, list(default_engines()))
    r = fleet_rate(cd, fleet, utilization, engines, weights)
    tenant = dict(engines=engines, engine_weights=weights)
    if kind == "poisson":
        tenants = [TenantSpec("all", PoissonArrivals(r), n_jobs, **tenant)]
    elif kind == "mmpp":
        # 7:1 burst ratio at the same time-averaged rate as "poisson"
        tenants = [TenantSpec(
            "bursty", MMPPArrivals((0.25 * r, 1.75 * r), (240.0, 240.0)),
            n_jobs, **tenant)]
    elif kind == "diurnal":
        period = max(600.0, 0.25 * n_jobs / r)    # a few cycles per trace
        tenants = [TenantSpec(
            "diurnal", DiurnalArrivals(r, amplitude=0.8, period_s=period),
            n_jobs, **tenant)]
    elif kind == "flash":
        span = n_jobs / r
        tenants = [TenantSpec(
            "flash", FlashCrowdArrivals(0.8 * r, spike_at=span / 3.0,
                                        spike_duration=span / 20.0,
                                        spike_factor=8.0), n_jobs,
            **tenant)]
    elif kind == "drift":
        # popularity flip: the capacity-proportional mix drifts until the
        # edge-friendly engines' aggregate traffic share and the
        # heavyweights' have swapped — the offline calibration priced the
        # heavy engines as rare, so the fleet slides into overload as the
        # mix goes stale.  Rate is calibrated at the midpoint mix: the
        # trace starts below target utilization and ends above it.
        w0 = np.asarray(weights, float)
        w0 = w0 / w0.sum()
        edge = np.fromiter((e in EDGE_ENGINES for e in engines),
                           dtype=bool, count=len(engines))
        s_edge, s_heavy = w0[edge].sum(), w0[~edge].sum()
        if s_edge > 0 and s_heavy > 0:
            w1 = np.where(edge, w0 * (s_heavy / s_edge),
                          w0 * (s_edge / s_heavy))
        else:                       # degenerate fleet: reverse the mix
            w1 = w0[::-1].copy()
        w_mid = 0.5 * (w0 + w1 / w1.sum())
        r_d = fleet_rate(cd, fleet, utilization, engines, list(w_mid))
        span = n_jobs / r_d
        tenants = [TenantSpec(
            "drift", DriftedArrivals(PoissonArrivals(r_d), list(w0),
                                     list(w1), span_s=span),
            n_jobs, engines=engines)]
    elif kind == "multi-tenant":
        edge_e, edge_w = _mix(cd, fleet, list(EDGE_ENGINES))
        heavy_e, heavy_w = _mix(cd, fleet, list(HEAVY_ENGINES))
        # utilization shares per tenant; job counts follow each tenant's
        # rate so the three traces overlap in time
        r_int = fleet_rate(cd, fleet, 0.5 * utilization, edge_e, edge_w)
        r_batch = fleet_rate(cd, fleet, 0.35 * utilization, heavy_e,
                             heavy_w)
        r_launch = fleet_rate(cd, fleet, 0.15 * utilization, edge_e,
                              edge_w)
        r_tot = r_int + r_batch + r_launch
        n_int = int(n_jobs * r_int / r_tot)
        n_batch = int(n_jobs * r_batch / r_tot)
        n_launch = n_jobs - n_int - n_batch
        span = n_jobs / r_tot
        tenants = [
            # interactive: small engines, tight QoS, steady traffic
            TenantSpec("interactive", PoissonArrivals(r_int), n_int,
                       engines=edge_e, engine_weights=edge_w,
                       qos_percentile=25.0),
            # batch: heavy engines, heavy-tail sizes, loose QoS, bursty
            TenantSpec("batch",
                       MMPPArrivals((0.4 * r_batch, 1.6 * r_batch),
                                    (300.0, 300.0)), n_batch,
                       engines=heavy_e, engine_weights=heavy_w,
                       sizes=ParetoSize(), qos_percentile=50.0,
                       qos_scale=3.0),
            # a product launch: flash crowd on the small engines
            TenantSpec("launch",
                       FlashCrowdArrivals(r_launch, spike_at=span / 2.0,
                                          spike_duration=span / 15.0,
                                          spike_factor=10.0),
                       n_launch, engines=edge_e, engine_weights=edge_w,
                       qos_percentile=50.0),
        ]
    else:
        raise ValueError(f"unknown scenario {kind!r}; one of {SCENARIOS}")
    if streaming is not None:
        ttft_scale, tpot_scale = streaming
        tenants = [dataclasses.replace(t, ttft_scale=ttft_scale,
                                       tpot_scale=tpot_scale)
                   for t in tenants]
    if patience is not None:
        tenants = [dataclasses.replace(t, patience_scale=patience)
                   for t in tenants]
    jobs = make_workload(cd, tenants, seed=seed)
    if serving == "batched":
        attach_requests(jobs, seed=seed, cd=cd, tenants=tenants)
    return jobs


# ---------------------------------------------------------------------------
# trace replay (JSON-lines serving logs)

TRACE_VERSION = 1
_TRACE_HEADER = "synergai_trace"


def _job_record(job: Job) -> dict:
    rec = {"id": job.id, "arrival": job.arrival, "engine": job.engine,
           "queries": job.queries, "t_qos": job.t_qos,
           "tenant": job.tenant}
    if job.patience is not None:
        rec["patience"] = job.patience
    if job.retry_budget is not None:
        rec["retry_budget"] = job.retry_budget
    if job.request is not None:
        r = job.request
        rec["prompt_tokens"] = r.prompt_tokens
        rec["decode_tokens"] = r.decode_tokens
        if r.ttft_qos is not None:
            rec["ttft_qos"] = r.ttft_qos
        if r.tpot_qos is not None:
            rec["tpot_qos"] = r.tpot_qos
    return rec


def save_trace(path, trace) -> int:
    """Export jobs as a JSON-lines trace; returns the record count.

    ``trace`` is a sequence of ``Job``s or of ``JobResult``s (a completed
    ``Simulator`` run — the jobs are pulled out of the results), written
    in arrival order after a one-line header.  Floats are serialized at
    full precision (json uses ``repr``), so ``load_trace`` round-trips
    every field bit-for-bit and a replayed run reproduces the original
    ``JobResult`` stream exactly (same fleet / policy / simulator seed).
    """
    jobs = [t.job if hasattr(t, "job") else t for t in trace]
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.id))
    with open(path, "w") as f:
        f.write(json.dumps({_TRACE_HEADER: TRACE_VERSION,
                            "jobs": len(jobs)}) + "\n")
        for job in jobs:
            f.write(json.dumps(_job_record(job)) + "\n")
    return len(jobs)


def _trace_error(path, lineno: int, msg: str) -> ValueError:
    return ValueError(f"{path}:{lineno}: {msg}")


def load_trace(path) -> List[Job]:
    """Parse a ``save_trace`` file back into the exact job list.

    Malformed input — missing/garbled header, non-JSON lines, missing or
    mistyped fields, a record-count mismatch — raises ``ValueError``
    naming the offending line."""
    jobs: List[Job] = []
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise _trace_error(path, 1, "empty file, expected a "
                           f"{{'{_TRACE_HEADER}': ...}} header")
    try:
        header = json.loads(lines[0])
    except json.JSONDecodeError as e:
        raise _trace_error(path, 1, f"bad header: {e}") from None
    if not isinstance(header, dict) or _TRACE_HEADER not in header:
        raise _trace_error(path, 1, f"not a SynergAI trace (missing "
                           f"{_TRACE_HEADER!r} header key)")
    if header[_TRACE_HEADER] != TRACE_VERSION:
        raise _trace_error(path, 1, f"unsupported trace version "
                           f"{header[_TRACE_HEADER]!r}")
    seen: set = set()
    for lineno, line in enumerate(lines[1:], 2):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise _trace_error(path, lineno, f"bad record: {e}") from None
        if not isinstance(rec, dict):
            raise _trace_error(path, lineno, "record is not an object")
        try:
            request = None
            if "prompt_tokens" in rec or "decode_tokens" in rec:
                request = Request(int(rec["prompt_tokens"]),
                                  int(rec["decode_tokens"]),
                                  (float(rec["ttft_qos"])
                                   if "ttft_qos" in rec else None),
                                  (float(rec["tpot_qos"])
                                   if "tpot_qos" in rec else None))
            jobs.append(Job(int(rec["id"]), str(rec["engine"]),
                            int(rec["queries"]), float(rec["t_qos"]),
                            float(rec["arrival"]), request=request,
                            tenant=str(rec.get("tenant", "")),
                            patience=(float(rec["patience"])
                                      if "patience" in rec else None),
                            retry_budget=(int(rec["retry_budget"])
                                          if "retry_budget" in rec
                                          else None)))
        except (KeyError, TypeError, ValueError) as e:
            raise _trace_error(path, lineno,
                               f"bad job record ({e!r})") from None
        if jobs[-1].id in seen:
            raise _trace_error(path, lineno, f"duplicate job id "
                               f"{jobs[-1].id} (the simulator keys "
                               f"running state by id)")
        seen.add(jobs[-1].id)
    n = header.get("jobs")
    if n is not None and n != len(jobs):
        raise _trace_error(path, 1, f"header promises {n} jobs, file "
                           f"holds {len(jobs)}")
    return jobs


def replay(trace) -> List[Job]:
    """Jobs ready to feed the simulator's event heap, from a trace file
    path, a job list, or a completed run's ``JobResult`` stream.  Jobs are
    arrival-sorted with their original ids preserved, so
    ``Simulator(...).run(replay(path))`` reproduces the exporting run
    bit-for-bit (same fleet, policy and simulator seed — the rng draws
    depend only on the event order, which the trace pins)."""
    if isinstance(trace, (str, bytes)) or hasattr(trace, "__fspath__"):
        jobs = load_trace(trace)
    else:
        jobs = [t.job if hasattr(t, "job") else t for t in trace]
    return sorted(jobs, key=lambda j: (j.arrival, j.id))


# ---------------------------------------------------------------------------
# external serving-log import (Azure LLM inference trace format)


def _azure_timestamp(raw: str, path, lineno: int) -> float:
    """Seconds from an Azure trace TIMESTAMP cell: either a plain float
    (relative seconds) or an ISO datetime — Azure publishes 7-digit
    fractional seconds, which ``fromisoformat`` rejects, so the fraction
    is truncated to microseconds first."""
    s = raw.strip()
    try:
        return float(s)
    except ValueError:
        pass
    import datetime
    m = s.replace("T", " ")
    if "." in m:
        head, frac = m.split(".", 1)
        frac = "".join(c for c in frac if c.isdigit())[:6]
        m = f"{head}.{frac or 0}"
    try:
        return datetime.datetime.fromisoformat(m).timestamp()
    except ValueError:
        raise _trace_error(path, lineno, f"bad TIMESTAMP {raw!r} "
                           "(want seconds or ISO datetime)") from None


def load_azure_llm_trace(cd: ConfigDict, path, engines=None,
                         qos_scale: float = 1.0,
                         qos_percentile: float = 50.0,
                         max_jobs: Optional[int] = None,
                         tenant: str = "azure") -> List[Job]:
    """Import an Azure-LLM-inference-style serving log as a job list.

    The public Azure trace is a CSV with (at least) ``TIMESTAMP``,
    ``ContextTokens`` and ``GeneratedTokens`` columns — request arrival
    plus prompt/generation token counts, with no engine or QoS columns.
    Each row becomes a ``Job``:

    - **engine**: the catalogue engine whose request *shape* best
      matches the row — minimize ``|log((ctx / prefill_len) /
      (gen / decode_len))|`` over ``engines`` — so prompt-heavy rows
      land on prompt-heavy engine shapes and the per-engine mix follows
      the trace instead of a synthetic sampler.
    - **queries**: the geometric mean of the prefill- and decode-implied
      query counts, ``max(1, round(sqrt(q_p * q_d)))``.
    - **request**: the row's exact token counts (the batched serving
      bridge uses them verbatim).
    - **t_qos**: ``qos_scale * qos_threshold(...)`` at
      ``qos_percentile`` — the same construction every synthetic
      scenario uses.
    - **arrival**: normalized so the first row arrives at ``t = 0``.

    Returns arrival-sorted jobs with sequential ids, ready for
    ``Simulator.run`` — and for ``save_trace``, which round-trips them
    bit-for-bit into the native replay format.  Malformed input (missing
    header columns, non-numeric or non-positive token counts, a bad
    timestamp) raises ``ValueError`` naming ``path:line``.
    """
    specs = dict(engines or default_engines())
    if not specs:
        raise ValueError("load_azure_llm_trace: empty engine catalogue")
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise _trace_error(path, 1, "empty file, expected a CSV header "
                           "with TIMESTAMP, ContextTokens, "
                           "GeneratedTokens")
    header = [c.strip().lower() for c in lines[0].split(",")]
    cols = {}
    for want in ("timestamp", "contexttokens", "generatedtokens"):
        if want not in header:
            raise _trace_error(path, 1, f"missing column {want!r} "
                               f"(header has {lines[0]!r})")
        cols[want] = header.index(want)
    shapes = sorted((name, spec.prefill_len, spec.decode_len)
                    for name, spec in specs.items())
    rows = []
    for lineno, line in enumerate(lines[1:], 2):
        if not line.strip():
            continue
        cells = line.split(",")
        if len(cells) < len(header):
            raise _trace_error(path, lineno, f"row has {len(cells)} "
                               f"cells, header has {len(header)}")
        at = _azure_timestamp(cells[cols["timestamp"]], path, lineno)
        try:
            ctx = int(float(cells[cols["contexttokens"]]))
            gen = int(float(cells[cols["generatedtokens"]]))
        except ValueError:
            raise _trace_error(path, lineno, "non-numeric token count "
                               f"{line!r}") from None
        if ctx <= 0 or gen <= 0:
            raise _trace_error(path, lineno, f"non-positive token "
                               f"count (ctx={ctx}, gen={gen})")
        rows.append((at, ctx, gen))
        if max_jobs is not None and len(rows) >= max_jobs:
            break
    if not rows:
        raise _trace_error(path, 2, "trace has a header but no rows")
    t0 = min(at for at, _c, _g in rows)
    jobs: List[Job] = []
    for at, ctx, gen in rows:
        best = None
        for name, plen, dlen in shapes:
            mismatch = abs(math.log((ctx / plen) / (gen / dlen)))
            if best is None or mismatch < best[0] - 1e-12:
                best = (mismatch, [(name, plen, dlen)])
            elif mismatch < best[0] + 1e-12:
                best[1].append((name, plen, dlen))
        # engines sharing a request shape tie; spread them by a
        # deterministic token-count hash instead of collapsing the whole
        # trace onto the alphabetically first name
        tied = best[1]
        engine, plen, dlen = tied[(ctx * 31 + gen) % len(tied)]
        q = max(1, round(math.sqrt((ctx / plen) * (gen / dlen))))
        t_qos = qos_scale * qos_threshold(cd, engine, q, qos_percentile)
        jobs.append(Job(0, engine, q, float(t_qos), at - t0,
                        request=Request(ctx, gen), tenant=tenant))
    jobs.sort(key=lambda j: j.arrival)
    for i, j in enumerate(jobs):
        j.id = i
    return jobs


# ---------------------------------------------------------------------------
# failure traces


def _failure_regions(fleet: Sequence[WorkerPool],
                     regions) -> Dict[str, List[str]]:
    """Resolve the ``synth_failures`` regions spec into
    ``{region: [pool names]}``: ``True`` reads ``WorkerPool.region`` tags
    (``synth_fleet(..., regions=k)`` sets them), an int groups the fleet
    round-robin, a mapping is taken as-is (every pool in at most one
    region)."""
    if regions is True:
        groups: Dict[str, List[str]] = {}
        for w in fleet:
            if not w.region:
                raise ValueError(f"pool {w.name!r} has no region tag; "
                                 f"build the fleet with synth_fleet(..., "
                                 f"regions=k) or pass regions=<int|dict>")
            groups.setdefault(w.region, []).append(w.name)
        return groups
    if isinstance(regions, int):
        if regions <= 0:
            raise ValueError("regions must be a positive int")
        groups = {}
        for i, w in enumerate(fleet):
            groups.setdefault(f"r{i % regions}", []).append(w.name)
        return groups
    if isinstance(regions, dict):
        names = {w.name for w in fleet}
        seen: set = set()
        for rname, pools in regions.items():
            if not pools:
                raise ValueError(f"region {rname!r} has no pools")
            for p in pools:
                if p not in names:
                    raise ValueError(f"region {rname!r} names unknown "
                                     f"pool {p!r}")
                if p in seen:
                    raise ValueError(f"pool {p!r} appears in more than "
                                     f"one region")
                seen.add(p)
        return {str(r): list(p) for r, p in regions.items()}
    raise ValueError(f"regions must be True, an int or a mapping, "
                     f"got {regions!r}")


def _flap_events(events: List[FailureEvent],
                 flap: int) -> List[FailureEvent]:
    """Crash-restart flapping: split each outage window into ``flap``
    short pulses at 50% duty cycle — pulse ``i`` covers
    ``[at + i*d/flap, at + i*d/flap + 0.5*d/flap)``.  Same envelope,
    same pool, but every pulse kills and requeues whatever was placed
    during the preceding half-window of apparent health (the
    retry-budget stress case)."""
    if flap <= 1:
        return events
    out: List[FailureEvent] = []
    for e in events:
        step = e.duration / flap
        for i in range(flap):
            out.append(FailureEvent(e.worker, e.at + i * step,
                                    0.5 * step))
    return sorted(out, key=lambda f: f.at)


def synth_failures(fleet: Sequence[WorkerPool], horizon_s: float,
                   mtbf_s: float, mttr_s: float, seed: int = 0,
                   regions=None,
                   correlation: float = 0.5,
                   flap: Optional[int] = None) -> List[FailureEvent]:
    """Synthetic failure traces for fleet-scale robustness runs (the
    simulator re-queues killed jobs).

    Default (``regions=None``): independent per-worker Poisson failures
    with exponential repair times — the original model, byte-identical
    output for a given seed.

    ``regions=`` switches to *correlated multi-region outages*
    (shared-infrastructure failures at the edge: power, uplink, cooling).
    Pools are grouped into regions (``True`` → ``WorkerPool.region``
    tags, int → round-robin, mapping → explicit); each region suffers
    Poisson outage events (mean gap ``mtbf_s``), and every event downs
    ``max(1, round(correlation * len(region)))`` of the region's pools
    *simultaneously* for one shared exponential repair window.  A
    region's next outage is drawn after the previous repair completes,
    so no pool's failure windows ever overlap.

    ``flap=k`` (k > 1) turns every outage into a flapping pool: the
    window is split into ``k`` crash-restart pulses at 50% duty cycle
    (see ``_flap_events``), so pools oscillate between apparent health
    and failure instead of staying down — jobs placed during the
    up-phases get killed and requeued repeatedly, stressing retry
    budgets.  ``None``/``1`` keeps the seed-identical solid windows."""
    rng = np.random.default_rng(seed)
    events: List[FailureEvent] = []
    if regions is None or regions is False:    # False == off, like
        regions = None                         # synth_fleet(disaggregate=)
    if regions is None:
        for w in fleet:
            t = rng.exponential(mtbf_s)
            while t < horizon_s:
                d = rng.exponential(mttr_s)
                events.append(FailureEvent(w.name, float(t), float(d)))
                t += d + rng.exponential(mtbf_s)
        events.sort(key=lambda f: f.at)
        return _flap_events(events, flap) if flap else events
    if not 0.0 < correlation <= 1.0:
        raise ValueError(f"correlation must be in (0, 1], "
                         f"got {correlation}")
    groups = _failure_regions(fleet, regions)
    for rname in sorted(groups):
        pools = groups[rname]
        n_down = max(1, int(round(correlation * len(pools))))
        t = rng.exponential(mtbf_s)
        while t < horizon_s:
            d = rng.exponential(mttr_s)
            down = rng.choice(len(pools), size=n_down, replace=False)
            for i in sorted(down):
                events.append(FailureEvent(pools[i], float(t), float(d)))
            t += d + rng.exponential(mtbf_s)
    events.sort(key=lambda f: f.at)
    return _flap_events(events, flap) if flap else events


def synth_degradations(fleet: Sequence[WorkerPool], horizon_s: float,
                       onset_s: Optional[float] = None,
                       duration_s: Optional[float] = None,
                       factor: float = 3.0, fraction: float = 0.35,
                       prefix: Optional[str] = None,
                       seed: int = 0) -> List[DegradationEvent]:
    """Synthetic *profile-drift* traces: a share of the fleet starts
    running slower than its offline characterization (thermal
    throttling, colocated tenants, a driver regression) while the
    ConfigDict keeps describing the healthy device — the scenario
    ``repro.core.recharacterize`` exists for.

    ``fraction`` of the pools (optionally restricted to names starting
    with ``prefix``, e.g. ``"edge"`` for the battery/thermal-limited
    tier) each get one ``DegradationEvent``: onset jittered uniformly in
    ``[onset_s, 1.25 * onset_s]`` (default ``horizon_s / 3`` — the
    detector's anchor windows see the healthy regime first), duration
    ``duration_s`` (default: through the end of the trace), slowdown
    jittered uniformly in ``[0.8, 1.2] * factor``."""
    if factor <= 0:
        raise ValueError(f"factor must be > 0, got {factor}")
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    names = [w.name for w in fleet
             if prefix is None or w.name.startswith(prefix)]
    if not names:
        raise ValueError(f"no pool name starts with {prefix!r}")
    rng = np.random.default_rng(seed)
    onset_s = horizon_s / 3.0 if onset_s is None else float(onset_s)
    n = max(1, int(round(fraction * len(names))))
    picks = rng.choice(len(names), size=n, replace=False)
    events = []
    for i in sorted(picks):
        at = float(onset_s * rng.uniform(1.0, 1.25))
        dur = (float(duration_s) if duration_s is not None
               else max(0.0, horizon_s - at) + horizon_s)
        f = float(factor * rng.uniform(0.8, 1.2))
        events.append(DegradationEvent(names[i], at, dur, f))
    return sorted(events, key=lambda d: d.at)
