# Port of repro/core/simulator.py: the same numpy code, imports rewritten to repro_torch.
"""Discrete-event cluster simulator for scheduler evaluation (paper §5).

Jobs run in strict isolation on their assigned worker (paper §5.1: "all jobs
scheduled and executed in strict isolation ... zero interference").  The
simulator also implements the fault-tolerance extensions (worker failure,
straggler slowdown, elastic pool membership) used by the robustness tests.

The engine is *event-indexed*: a single ``heapq`` holds every future
wake-up (job arrival, job completion, worker failure, failure recovery,
elastic-provision completion) so advancing time is O(log n) instead of the
seed's per-iteration rescan of every worker, failure and running job.
Entries whose underlying state changed (a speculated job's new finish time,
a killed job, a retired clone) are invalidated lazily at pop time, which
keeps the wake sequence — and therefore the simulated schedule — identical
to the reference tick-scanning loop preserved in
``repro.core.simulator_legacy.LegacySimulator``.  Fleet-scale runs
(10k jobs x 64 pools) complete in seconds; see
``benchmarks/scheduler_experiments.py`` for the old-vs-new comparison.

Two serving models share the engine (``Simulator(..., serving=...)``):

* ``"job"`` (default, the paper's model) — a job occupies its worker
  exclusively for ``exec_time`` seconds.
* ``"batched"`` — the serving bridge (``repro.core.serving_bridge``):
  workers run continuous batches of same-engine jobs under max-batch and
  KV-cache-byte budgets, a prefill phase plus per-token decode draining at
  the profile-calibrated token rates, and every batch change re-estimates
  member completions through the event heap.  ``BatchedWorkerSim`` below
  holds the per-worker batch state; the profile math lives in the bridge
  module.

Both modes report *streaming QoS* per request — ``JobResult.ttft``
(arrival to first decoded token) and ``JobResult.tpot`` (seconds per
decoded token after it) — and enforce the optional per-job deadlines on
``Request.ttft_qos`` / ``tpot_qos``.  Batched mode additionally supports
*prefill/decode-disaggregated pools* (``WorkerPool.role``): jobs run a
prefill phase on a prefill pool, re-enter the queue as an
independently-placed decode phase, and pull their parked KV cache over
the disaggregation link (``serving_bridge.kv_transfer_s``) at decode
admission — free when the decode leg lands back on the same
``role="both"`` pool.  Design note: ``docs/serving_bridge.md``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.configdict import ConfigDict, Entry
from repro_torch.core.job import Job, Request, exec_time
from repro_torch.core.serving_bridge import batch_multiplier
from repro_torch.core.workers import WorkerPool, default_fleet


@dataclasses.dataclass
class WorkerSim:
    pool: WorkerPool
    busy_until: float = 0.0
    last_freed: float = 0.0
    last_assigned: float = -math.inf
    energy_j: float = 0.0
    n_jobs: int = 0
    busy_s: float = 0.0
    failed_until: float = 0.0      # fault injection
    slowdown: float = 1.0          # straggler injection
    # static-floor joules burned while parked (idle/static power floor,
    # constants.IDLE_POWER_FRACTION) — settled once by Simulator.run at
    # end of run, kept separate so ``energy_j`` stays "active energy"
    # (the paper's Fig. 12 TDP methodology)
    idle_energy_j: float = 0.0

    @property
    def total_energy_j(self) -> float:
        return self.energy_j + self.idle_energy_j

    def __setattr__(self, name, value):
        # write-through into the Cluster's struct-of-arrays mirror
        # (attached lazily by Cluster._build_arrays): scalar state stays
        # authoritative on the instance, the arrays feed the schedulers'
        # O(W) vector ops.  A failure write also bumps the cluster's
        # failure generation, the score-cache invalidation signal.
        object.__setattr__(self, name, value)
        if name == "busy_until":
            a = self.__dict__.get("_arrays")
            if a is not None:
                a.busy_until[self._aidx] = value
        elif name == "failed_until":
            a = self.__dict__.get("_arrays")
            if a is not None:
                a.failed_until[self._aidx] = value
            c = self.__dict__.get("_cluster")
            if c is not None:
                c._fail_gen += 1

    def idle(self, now: float) -> bool:
        return self.busy_until <= now and self.failed_until <= now


@dataclasses.dataclass
class _InFlight:
    """One continuous-batch member, tracked in solo-equivalent service
    seconds: ``work_s`` total, ``served_s`` done so far (drains at
    ``m(b)`` of the solo rate).  ``prefill_s`` marks the boundary between
    the admission+prefill prefix and the per-token decode phase, matching
    the real engine's prefill-then-decode loop
    (``repro.serving.engine``).  ``prefill_done_at`` is the wall time the
    member crossed that boundary — the first decoded token, interpolated
    exactly inside ``accrue`` (the drain rate is constant between batch
    events) and the source of the per-request TTFT."""

    jid: int
    work_s: float
    prefill_s: float
    request: Request
    served_s: float = 0.0
    prefill_done_at: Optional[float] = None

    @property
    def remaining_s(self) -> float:
        return self.work_s - self.served_s


@dataclasses.dataclass
class BatchedWorkerSim(WorkerSim):
    """Continuous-batching service model for one worker pool (the serving
    bridge, ``serving="batched"``; profile math in
    ``repro.core.serving_bridge``).

    Replaces exclusive occupancy with an active batch of same-engine
    jobs.  ``idle`` means "can admit another member"; ``busy_until``
    tracks the earliest slot-free time while the batch is full (so
    policies' backlog estimates keep working) and the provisioning delay
    of elastic clones."""

    max_batch: int = 8
    alpha_override: Optional[float] = None
    active: Dict[int, _InFlight] = dataclasses.field(default_factory=dict)
    last_progress: float = 0.0
    batch_engine: Optional[str] = None
    batch_entry: Optional[Entry] = None
    batch_alpha_: float = 0.5
    kv_limit: int = 1
    kv_job_bytes: float = 0.0
    # serving stats (EngineStats analogue at fleet scale)
    admitted: int = 0
    peak_batch: int = 0
    prefill_tokens: int = 0
    decoded_tokens: int = 0
    abandoned: int = 0
    # WAN-transfer seconds folded into members' service (cross-region
    # input shipping, KV handoffs) still pending their energy re-rate:
    # the chips idle while the wire moves bytes, so ``accrue`` bills the
    # next ``xfer_debt_s`` wall-seconds at the batch entry's static floor
    # instead of its full draw.  ``xfer_idle_s`` counts the seconds
    # already re-rated (energy-conservation tests reconcile with it).
    xfer_debt_s: float = 0.0
    xfer_idle_s: float = 0.0

    def _has_slot(self) -> bool:
        return (not self.active
                or len(self.active) < min(self.max_batch, self.kv_limit))

    def _sync_batch(self):
        """Mirror the batch state (depth, slot budget, engine lock,
        alpha) into the cluster's struct-of-arrays after every membership
        change — ``active`` is a dict, so ``__setattr__`` can't see it."""
        a = self.__dict__.get("_arrays")
        if a is None:
            return
        i = self._aidx
        a.depth[i] = len(self.active)
        a.slot_cap[i] = min(self.max_batch, self.kv_limit)
        eng = self.batch_engine
        a.engine_id[i] = (-1 if eng is None
                          else self._cluster.engine_code(eng))
        a.alpha[i] = self.batch_alpha_

    def idle(self, now: float) -> bool:
        return (self.busy_until <= now and self.failed_until <= now
                and self._has_slot())

    def can_admit(self, engine: str, now: float) -> bool:
        return self.idle(now) and (self.batch_engine is None
                                   or self.batch_engine == engine)

    def multiplier(self, b: Optional[int] = None) -> float:
        return batch_multiplier(self.batch_alpha_,
                                len(self.active) if b is None else b)

    def accrue(self, now: float):
        """Drain every member by the elapsed wall time at the current
        batch multiplier; account busy time and energy (the whole batch
        shares one engine's power draw — batching's energy win)."""
        dt = now - self.last_progress
        self.last_progress = now
        if not self.active or dt <= 0:
            return
        m = self.multiplier()
        t0 = now - dt
        for f in self.active.values():
            before = f.served_s
            f.served_s = min(f.work_s, before + dt * m)
            if f.prefill_done_at is None and f.served_s >= f.prefill_s:
                # first token: the drain rate is constant over [t0, now],
                # so the prefill-boundary crossing interpolates exactly
                f.prefill_done_at = t0 + (f.prefill_s - before) / m
        self.busy_s += dt
        self.energy_j += self.batch_entry.power_w * dt
        if self.xfer_debt_s > 0.0:
            # re-rate pending WAN-transfer seconds at the idle floor
            pay = min(self.xfer_debt_s, dt)
            self.energy_j -= ((self.batch_entry.power_w
                               - self.batch_entry.idle_power_w) * pay)
            self.xfer_debt_s -= pay
            self.xfer_idle_s += pay

    def admit(self, now: float, jid: int, engine: str, entry: Entry,
              prof, request: Request, work_s: float, prefill_s: float):
        assert self.batch_engine in (None, engine), "mixed-engine batch"
        if not self.active:
            self.batch_engine = engine
            self.batch_entry = entry
            self.batch_alpha_ = (self.alpha_override
                                 if self.alpha_override is not None
                                 else prof.alpha)
            self.kv_limit = prof.kv_limit
            self.kv_job_bytes = prof.kv_job_bytes
            self.last_progress = now
        f = _InFlight(jid, work_s, prefill_s, request)
        if prefill_s <= 0.0:        # decode-only phase: first token is past
            f.prefill_done_at = now
        self.active[jid] = f
        self.admitted += 1
        self.peak_batch = max(self.peak_batch, len(self.active))
        self._sync_batch()

    def finish(self, jid: int) -> Optional[_InFlight]:
        """Retire a fully-served member; tokens count here and only here,
        so a member killed by a failure mid-flight contributes nothing
        (its re-dispatch counts once, wherever it completes)."""
        f = self.active.pop(jid, None)
        if f is not None:
            self.prefill_tokens += f.request.prompt_tokens
            self.decoded_tokens += f.request.decode_tokens
        if not self.active:
            self.batch_engine = None
            self.batch_entry = None
        self._sync_batch()
        return f

    def abandon(self, jid: int) -> Optional[_InFlight]:
        """A member's client hung up mid-batch: the member leaves and its
        partial service is lost.  Tokens only count in ``finish``, so an
        abandoned member contributes nothing to the worker's token
        totals — exact token conservation, same rule as a failure kill.
        Callers must ``accrue(now)`` first and ``_rebatch`` after (the
        survivors speed up)."""
        f = self.active.pop(jid, None)
        if f is not None:
            self.abandoned += 1
        if not self.active:
            self.batch_engine = None
            self.batch_entry = None
        self._sync_batch()
        return f

    def on_failure(self, now: float):
        """Worker died: partial service is lost, the batch resets (the
        simulator re-queues every killed member for checkpoint-restart)."""
        self.accrue(now)
        self.active.clear()
        self.batch_engine = None
        self.batch_entry = None
        self.xfer_debt_s = 0.0     # the transfers died with the batch
        self._sync_batch()


@dataclasses.dataclass
class Assignment:
    job: Job
    worker: str
    entry: Entry
    # cross-region placement surcharge (repro/core/hierarchy.py): seconds
    # of inter-region input shipping (REGION_XFER link) charged ahead of
    # the job's service.  0.0 — the default every flat policy uses —
    # changes nothing bit-for-bit.
    xfer_s: float = 0.0


@dataclasses.dataclass
class JobResult:
    job: Job
    worker: str
    config: str
    start: float
    end: float
    waiting: float
    exec_s: float
    e2e: float
    violated: bool
    excess: float
    overhead_s: float
    decision_s: float
    speculated: bool = False
    # streaming QoS (both serving modes): seconds from arrival to the
    # first decoded token, and average seconds per decoded token after it.
    # Under disaggregated pools the transfer + decode-queue time lands in
    # ``tpot`` (TTFT is the prefill pool's first token).  ``violated``
    # ORs the streaming deadline misses in; with no deadlines set the
    # *_violated flags stay False and ``violated`` keeps its end-to-end
    # meaning bit-for-bit.
    ttft: float = math.nan
    tpot: float = math.nan
    ttft_violated: bool = False
    tpot_violated: bool = False
    prefill_worker: Optional[str] = None   # disaggregated: prefill pool
    # solo service seconds: slowdown- and noise-scaled service time
    # excluding batch contention, cross-region transfer and queueing —
    # what the worker's *physics* cost, which is the observable online
    # re-characterization fits drift from (``exec_s`` is stretched by
    # the live batch multiplier under ``serving="batched"``, so profile
    # drift and load contention would be confounded there).  Spans both
    # legs of a disaggregated job.
    service_s: float = math.nan
    # the offline profile's prediction for the same solo service (no
    # slowdown, no noise): what a real serving stack knows about each
    # request from its characterization tables.  ``service_s /
    # service_pred_s`` is therefore exactly ``slowdown * exec noise`` —
    # the drift observable, free of service-model approximation error.
    service_pred_s: float = math.nan
    # terminal outcome taxonomy (docs/robustness.md).  ``""`` means the
    # job was actually served — ``metrics.outcome_of`` refines that into
    # ``"completed"`` / ``"violated"`` from the flags above.  The
    # overload-control layer writes the non-served outcomes: ``"shed"``
    # (dropped by the OverloadController), ``"abandoned"`` (client
    # patience expired in queue), ``"failed"`` (retry budget exhausted).
    outcome: str = ""


@dataclasses.dataclass
class FailureEvent:
    worker: str
    at: float
    duration: float


@dataclasses.dataclass
class LinkFailureEvent:
    """A WAN partition between two regions: the ``REGION_XFER`` link
    connecting regions ``a`` and ``b`` (both directions) is severed for
    ``[at, at + duration)``.  While active, the hierarchical scheduler
    masks the pair out of cross-region spillover
    (``RegionRouter.blocked_regions``) and a disaggregated decode leg
    trying to pull its KV cache across the dead link loses the cache —
    the job restarts from prefill under its retry budget.  Intra-region
    traffic is unaffected; fleets without region tags never see one."""

    a: str
    b: str
    at: float
    duration: float


@dataclasses.dataclass
class RetryEvent:
    """Bookkeeping for one backoff re-entry scheduled on the event heap
    (``Simulator.retry_events``): the job re-joins the scan queue at
    ``at``.  ``attempt`` counts failure-driven re-executions so far (0
    for an outage-parking entry, which consumes no budget)."""

    job_id: int
    at: float
    attempt: int


@dataclasses.dataclass
class DegradationEvent:
    """A worker running slower than its offline profile for a window:
    thermal throttling, a colocated tenant, a driver regression.  The
    worker keeps serving (unlike a ``FailureEvent``) at ``factor``x its
    characterized service time — and *nothing tells the policies*: the
    profiles in the ConfigDict still describe the healthy device, so
    estimates on the degraded rows are silently wrong until an online
    re-characterization (``repro.core.recharacterize``) corrects the
    beliefs.  Overlapping windows on one worker compose
    multiplicatively."""

    worker: str
    at: float
    duration: float
    factor: float = 3.0


# pool roles / serving phases as small ints for the vectorized masks.
# ROLE_CODE["both"] == PHASE_CODE["full"] == 0, so the role gate is the
# single vector op ``(role == 0) | (role == PHASE_CODE[phase])``: a
# whole-job placement only passes "both" pools, a phase-sliced one its
# matching specialized pools plus "both" — exactly ``Cluster.role_ok``.
ROLE_CODE = {"both": 0, "prefill": 1, "decode": 2}
PHASE_CODE = {"full": 0, "prefill": 1, "decode": 2}
PHASE_NAME = {0: "full", 1: "prefill", 2: "decode"}


@dataclasses.dataclass(eq=False)
class _FleetArrays:
    """Struct-of-arrays mirror of ``Cluster.workers`` (docs/performance.md).

    One slot per worker, in dict insertion order.  ``busy_until`` /
    ``failed_until`` are written through by ``WorkerSim.__setattr__``,
    the batch columns by ``BatchedWorkerSim._sync_batch``; membership
    changes (elastic clones) rebuild the whole mirror lazily.  Schedulers
    read these for O(W) vector availability / penalty / admission masks
    instead of Python loops over the worker dict."""

    names: List[str]
    index: Dict[str, int]
    busy_until: np.ndarray        # [W] f64
    failed_until: np.ndarray      # [W] f64
    role: np.ndarray              # [W] i8, ROLE_CODE of pool.role
    depth: np.ndarray             # [W] i32, live batch size (0 in job mode)
    slot_cap: np.ndarray          # [W] i32, min(max_batch, kv_limit)
    engine_id: np.ndarray         # [W] i32, interned batch engine (-1 none)
    alpha: np.ndarray             # [W] f64, live batch_alpha_


class _WorkerDict(dict):
    """``Cluster.workers``: a plain dict plus membership hooks, so adding
    or retiring a pool (elastic scaling) invalidates the struct-of-arrays
    mirror and bumps the fleet generation without any caller changes."""

    def __init__(self, cluster: "Cluster"):
        super().__init__()
        self._cluster = cluster

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._cluster._fleet_changed()

    def __delitem__(self, key):
        super().__delitem__(key)
        self._cluster._fleet_changed()

    # every other mutator must invalidate too — a membership change that
    # slipped past the hooks would leave schedulers scoring ghost columns
    def pop(self, key, *default):
        had = key in self
        out = super().pop(key, *default)
        if had:
            self._cluster._fleet_changed()
        return out

    def popitem(self):
        out = super().popitem()
        self._cluster._fleet_changed()
        return out

    def clear(self):
        had = bool(self)
        super().clear()
        if had:
            self._cluster._fleet_changed()

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)
        self._cluster._fleet_changed()

    def setdefault(self, key, default=None):
        had = key in self
        out = super().setdefault(key, default)
        if not had:
            self._cluster._fleet_changed()
        return out


_CLUSTER_SERIAL = itertools.count()


class Cluster:
    def __init__(self, cd: ConfigDict, fleet: Optional[Sequence[WorkerPool]]
                 = None, serving: str = "job", max_batch: int = 8,
                 batch_alpha: Optional[float] = None):
        self.cd = cd
        self.serving = serving
        self._max_batch = max_batch
        self._batch_alpha = batch_alpha
        # struct-of-arrays state: the mirror itself (built lazily), the
        # membership / failure generations (score-cache invalidation), a
        # process-unique serial (so caches never confuse two clusters),
        # and the interned engine ids for the batch-engine column
        self.serial = next(_CLUSTER_SERIAL)
        self._arrays: Optional[_FleetArrays] = None
        self._member_gen = 0
        self._fail_gen = 0
        self._worker_token: Optional[int] = None
        self._engine_code: Dict[str, int] = {}
        self.workers: Dict[str, WorkerSim] = _WorkerDict(self)
        for w in (fleet or default_fleet()):
            self.workers[w.name] = self._make_worker(w)
        # prefill/decode disaggregation (docs/serving_bridge.md): pools
        # carry a phase role, jobs move through prefill -> decode phases
        # tracked here (maintained by the simulator); a whole-job cluster
        # reports phase "full" and gates nothing.
        self.disaggregated = serving == "batched" and any(
            ws.pool.role != "both" for ws in self.workers.values())
        self.job_phase: Dict[int, str] = {}
        # WAN partition timeline (``LinkFailureEvent``, installed by the
        # Simulator): severed region pairs gate cross-region spillover
        # and KV pulls while active.  Empty — the default — is free.
        self.link_outages: List[LinkFailureEvent] = []
        self._part_memo: tuple = (None, frozenset())

    def _make_worker(self, pool: WorkerPool) -> WorkerSim:
        if self.serving == "batched":
            ws = BatchedWorkerSim(pool, max_batch=self._max_batch,
                                  alpha_override=self._batch_alpha)
        else:
            ws = WorkerSim(pool)
        ws._cluster = self        # failure writes bump self._fail_gen
        return ws

    # -- struct-of-arrays mirror + generations -------------------------

    def _fleet_changed(self):
        self._arrays = None
        self._member_gen += 1
        self._worker_token = None

    @property
    def fleet_gen(self) -> int:
        """Monotone fleet generation: bumps on every membership change
        (elastic clone added/retired) and every failure injection — the
        coarse invalidation token for cross-tick score caches."""
        return self._member_gen + self._fail_gen

    @property
    def fail_gen(self) -> int:
        """Failure-only generation (membership changes excluded): lets a
        score cache distinguish an appended clone (extend columns) from a
        failure (flush)."""
        return self._fail_gen

    @property
    def worker_token(self) -> int:
        """Interned id of the current worker-name tuple (see
        ``estimator.intern_worker_tuple``): the cheap per-tick cache key
        that replaces hashing hundreds of pool names every call."""
        tok = self._worker_token
        if tok is None:
            from repro_torch.core.estimator import intern_worker_tuple
            tok = self._worker_token = intern_worker_tuple(self.cd,
                                                           self.workers)
        return tok

    def engine_code(self, engine: str) -> int:
        code = self._engine_code.get(engine)
        if code is None:
            code = self._engine_code[engine] = len(self._engine_code)
        return code

    @property
    def arrays(self) -> _FleetArrays:
        a = self._arrays
        if a is None:
            a = self._arrays = self._build_arrays()
        return a

    def _build_arrays(self) -> _FleetArrays:
        names = list(self.workers)
        W = len(names)
        a = _FleetArrays(
            names=names, index={n: i for i, n in enumerate(names)},
            busy_until=np.empty(W), failed_until=np.empty(W),
            role=np.zeros(W, np.int8), depth=np.zeros(W, np.int32),
            slot_cap=np.ones(W, np.int32),
            engine_id=np.full(W, -1, np.int32), alpha=np.full(W, 0.5))
        batched = self.serving == "batched"
        for i, ws in enumerate(self.workers.values()):
            a.busy_until[i] = ws.busy_until
            a.failed_until[i] = ws.failed_until
            a.role[i] = ROLE_CODE[ws.pool.role]
            ws._arrays = a
            ws._aidx = i
            if batched:
                ws._sync_batch()
        return a

    # -- vectorized scheduler views (O(W), no Python worker loops) -----

    def avail_array(self, now: float) -> np.ndarray:
        """[W] bool: ``WorkerSim.idle`` over the whole fleet (in batched
        mode: a free slot under the max-batch / KV budgets)."""
        a = self.arrays
        free = (a.busy_until <= now) & (a.failed_until <= now)
        if self.serving == "batched":
            free &= (a.depth == 0) | (a.depth < a.slot_cap)
        return free

    def busy_wait_array(self, now: float) -> np.ndarray:
        """[W] f64: seconds until each worker frees (0 when idle)."""
        a = self.arrays
        return np.maximum(0.0, np.maximum(a.busy_until - now,
                                          a.failed_until - now))

    def depth_penalty_array(self, now: float) -> np.ndarray:
        """[W] f64: ``depth_penalty`` over the whole fleet in one shot."""
        a = self.arrays
        pen = np.ones(len(a.names))
        if self.serving == "batched":
            m = ((a.depth > 0) & (a.busy_until <= now)
                 & (a.failed_until <= now) & (a.depth < a.slot_cap))
            if m.any():
                pen[m] = 1.0 + a.alpha[m] * a.depth[m]
        return pen

    def admit_engine_mask(self, engine: str, now: float,
                          phase: str = "full") -> np.ndarray:
        """[W] bool: ``admit_engine_ok`` over the whole fleet — the
        batch-formation + phase-role gate as one vector op instead of
        ``keys x W`` Python calls per tick."""
        a = self.arrays
        ok = (a.busy_until <= now) & (a.failed_until <= now)
        if self.disaggregated:
            ok &= (a.role == 0) | (a.role == PHASE_CODE[phase])
        if self.serving == "batched":
            ok &= (a.depth == 0) | (a.depth < a.slot_cap)
            eid = self._engine_code.get(engine, -2)   # -2: never batched
            ok &= (a.engine_id == -1) | (a.engine_id == eid)
        return ok

    def partitioned_pairs(self, now: float) -> frozenset:
        """Region pairs (as ``frozenset({a, b})``) whose WAN link is
        severed at ``now`` — memoized per timestamp, so per-job checks
        within one scheduler tick cost a dict probe."""
        memo_t, memo_v = self._part_memo
        if memo_t == now:
            return memo_v
        pairs = frozenset(frozenset((ev.a, ev.b))
                          for ev in self.link_outages
                          if ev.at <= now < ev.at + ev.duration)
        self._part_memo = (now, pairs)
        return pairs

    def link_down(self, r1: str, r2: str, now: float) -> bool:
        """Is the REGION_XFER link between two regions severed right now?"""
        if not self.link_outages or r1 == r2:
            return False
        return frozenset((r1, r2)) in self.partitioned_pairs(now)

    def idle_workers(self, now: float) -> List[str]:
        return [n for n, w in self.workers.items() if w.idle(now)]

    def feasible(self, engine: str, worker: str, use_default: bool) -> bool:
        ent = (self.cd.default_entry(engine, worker) if use_default
               else self.cd.optimal(engine, worker))
        return ent is not None and ent.qps > 0

    # -- serving-bridge views (identical to plain idleness in job mode) ----

    def phase_of(self, job: Job) -> str:
        """The job's current serving phase: ``"full"`` outside
        disaggregated clusters; ``"prefill"`` then ``"decode"`` inside one
        (every job starts at prefill; the simulator advances it)."""
        if not self.disaggregated:
            return "full"
        return self.job_phase.get(job.id, "prefill")

    def role_ok(self, job: Job, worker: str) -> bool:
        """Pool-role gate: a ``prefill``/``decode`` pool only serves its
        phase; ``both`` pools serve anything.  Always True outside
        disaggregated clusters."""
        if not self.disaggregated:
            return True
        role = self.workers[worker].pool.role
        return role == "both" or role == self.phase_of(job)

    def admit_ok(self, job: Job, worker: str, now: float) -> bool:
        """Can ``worker`` start/admit ``job`` right now?  In job mode this
        is plain idleness; in batched mode it adds the bridge's batch
        formation rules (same engine, free slot, KV headroom) and, under
        disaggregated pools, the phase-role match."""
        if not self.role_ok(job, worker):
            return False
        ws = self.workers[worker]
        if isinstance(ws, BatchedWorkerSim):
            return ws.can_admit(job.engine, now)
        return ws.idle(now)

    def admit_engine_ok(self, engine: str, worker: str, now: float,
                        phase: str = "full") -> bool:
        ws = self.workers[worker]
        if self.disaggregated:
            role = ws.pool.role
            if role != "both" and role != phase:
                return False
        if isinstance(ws, BatchedWorkerSim):
            return ws.can_admit(engine, now)
        return ws.idle(now)

    def depth_penalty(self, worker: str, now: float) -> float:
        """Queue-depth-adjusted latency factor: how much slower a job runs
        if it joins ``worker``'s current batch (``1 + alpha * b`` for a
        joinable batch of ``b``; 1.0 in job mode, for empty batches, and
        for full batches the job would have to wait out anyway)."""
        ws = self.workers[worker]
        if (isinstance(ws, BatchedWorkerSim) and ws.active
                and ws.idle(now)):
            return 1.0 + ws.batch_alpha_ * len(ws.active)
        return 1.0


class Policy:
    """Interface: look at the queue, return assignments onto idle workers."""

    name = "base"
    use_default_config = True       # baselines use device defaults (paper)

    def on_arrival(self, job: Job, cluster: Cluster, now: float):
        pass

    def on_requeue(self, job: Job, cluster: Cluster, now: float):
        """A previously-placed (or staged) job re-entered the queue —
        failure checkpoint-restart, or a parked KV cache lost with its
        pool.  Routing policies re-evaluate the job here; the default is
        inert so every flat policy is untouched."""
        pass

    def on_complete(self, result: "JobResult", cluster: Cluster,
                    now: float):
        """A job finished: its ``JobResult`` is final (both serving
        modes).  Online policies observe outcomes here — e.g. the
        ``OnlineRecharacterizer``'s observed-vs-predicted service-time
        residuals.  The default is inert so every existing policy (and
        schedule) is untouched."""
        pass

    def on_terminal(self, job: Job, cluster: Cluster, now: float):
        """A job left the system *without* completing — shed by the
        overload controller, abandoned by its client, or failed out of
        its retry budget.  Stateful policies release per-job state here
        (SynergAI reclaims the job's ScoreCache row, the hierarchical
        router drops its home assignment).  Default inert."""
        pass

    def schedule(self, now: float, queue: List[Job], cluster: Cluster
                 ) -> List[Assignment]:
        raise NotImplementedError


# wake-up kinds on the event heap
_W_ARRIVAL, _W_FAILURE, _W_COMPLETE, _W_RECOVER, _W_FREE = range(5)


class Simulator:
    def __init__(self, cd: ConfigDict, policy: Policy,
                 fleet: Optional[Sequence[WorkerPool]] = None,
                 tick: float = 1.0,
                 failures: Sequence[FailureEvent] = (),
                 degradations: Sequence[DegradationEvent] = (),
                 straggler_prob: float = 0.0,
                 straggler_factor: float = 3.0,
                 speculative: bool = False,
                 exec_noise: float = 0.2,
                 elastic_max: int = 0,
                 elastic_threshold: int = 6,
                 provision_s: float = 30.0,
                 serving: str = "job",
                 max_batch: int = 8,
                 batch_alpha: Optional[float] = None,
                 engines: Optional[dict] = None,
                 link_failures: Sequence[LinkFailureEvent] = (),
                 retry_budget: Optional[int] = None,
                 retry_base_s: float = 2.0,
                 retry_jitter: float = 0.5,
                 elastic_cooldown_s: float = 0.0,
                 seed: int = 0):
        if serving not in ("job", "batched"):
            raise ValueError(f"serving must be 'job' or 'batched', "
                             f"got {serving!r}")
        if serving == "batched" and speculative:
            raise ValueError("speculative re-dispatch is not supported "
                             "with serving='batched' (a batch member has "
                             "no single backup worker)")
        self.serving = serving
        # engine shapes are needed in both modes: batched serving derives
        # token rates from them, job mode uses decode_len for the TTFT/TPOT
        # streaming metrics
        from repro_torch.core.engines import default_engines
        self._engines = dict(engines or default_engines())
        self.cd = cd
        self.policy = policy
        self.cluster = Cluster(cd, fleet, serving=serving,
                               max_batch=max_batch, batch_alpha=batch_alpha)
        if serving != "batched" and any(
                ws.pool.role != "both" for ws in
                self.cluster.workers.values()):
            raise ValueError(
                "prefill/decode-disaggregated fleets (WorkerPool.role != "
                "'both') require serving='batched'")
        self._disagg = self.cluster.disaggregated
        # disaggregation state: results parked between prefill completion
        # and decode dispatch, per-job KV-pull delays (charged at decode
        # admission), and the heap of decode legs awaiting re-queue
        self._between: Dict[int, JobResult] = {}
        self._xfer_s: Dict[int, float] = {}
        self._handoff: list = []
        self.tick = tick
        self.failures = sorted(failures, key=lambda f: f.at)
        self.degradations = sorted(degradations, key=lambda d: d.at)
        self.straggler_prob = straggler_prob
        self.straggler_factor = straggler_factor
        self.speculative = speculative
        # run-to-run execution variance (real inference serving is noisy;
        # schedulers only see profiled expectations).  Lognormal, mean 1.
        self.exec_noise = exec_noise
        # elastic scaling: clone the strongest pool under queue pressure.
        # ``elastic_cooldown_s`` is the scale-down hysteresis window:
        # clones only retire once the pressure trigger (queue depth >=
        # threshold) has been quiet that long, so a single flash crowd
        # doesn't thrash clone/retire cycles.  0.0 — the default — is
        # the historical retire-on-empty behavior, bit-for-bit.
        self.elastic_max = elastic_max
        self.elastic_threshold = elastic_threshold
        self.provision_s = provision_s
        self.elastic_cooldown_s = elastic_cooldown_s
        self._clones = 0
        self._clone_names: List[str] = []
        self._last_pressure = -math.inf
        self.elastic_clones_total = 0
        self.elastic_retires_total = 0
        # ---- overload control / failure hardening (docs/robustness.md),
        # all inert by default ----
        # retry budget + exponential backoff: a failure requeue parks the
        # job on ``self._retry`` for ``retry_base_s * 2^attempt`` seconds
        # (jittered from the sim RNG — drawn only when the feature is on,
        # so the historical draw order is untouched) instead of instantly
        # re-entering the scan queue; budget exhaustion is terminal
        # ``outcome="failed"``.  ``retry_budget=None`` (and no per-job
        # override) keeps instant-requeue-forever.
        self.retry_budget = retry_budget
        self.retry_base_s = retry_base_s
        self.retry_jitter = retry_jitter
        self.link_failures = sorted(link_failures, key=lambda e: e.at)
        self._retry: list = []              # (ready, seq, job) backoff heap
        self._parked: set = set()           # job ids currently on _retry
        self._abandon: list = []            # (deadline, seq, job) patience
        self._attempts: Dict[int, int] = {}
        self._terminal: set = set()         # ids with a terminal outcome
        self._feas_cache: Dict[tuple, list] = {}
        self.retry_events: List[RetryEvent] = []
        self._results: Optional[List[JobResult]] = None
        # per-main-loop-iteration queue depth samples (post-control), the
        # bounded-p99-depth observable of bench_overload; and the
        # iteration count, pinned by the outage hot-loop regression test
        self.queue_depths: List[int] = []
        self.loop_iters = 0
        self.rng = np.random.default_rng(seed)
        # event heap; None outside run() (and always for LegacySimulator),
        # which turns the _notify hooks into no-ops
        self._heap: Optional[list] = None
        self._seq = itertools.count()

    # ------------------------------------------------------------------
    # event-heap bookkeeping (no-ops when self._heap is None)

    def _notify_end_changed(self, jid: int, end: float):
        if self._heap is not None:
            heapq.heappush(self._heap, (end, next(self._seq),
                                        _W_COMPLETE, jid))

    def _notify_worker_free(self, worker: str, at: float):
        if self._heap is not None:
            heapq.heappush(self._heap, (at, next(self._seq), _W_FREE, worker))

    def _wake_valid(self, t: float, kind: int, payload,
                    running: Dict[int, JobResult]) -> bool:
        if kind in (_W_ARRIVAL, _W_FAILURE):
            return True          # arrival/failure times are static
        if kind == _W_COMPLETE:
            rec = running.get(payload)
            return rec is not None and rec.end == t
        ws = self.cluster.workers.get(payload)
        if kind == _W_RECOVER:
            return ws is not None and ws.failed_until == t
        return ws is not None and ws.busy_until == t          # _W_FREE

    def _next_wake(self, now: float, queue: List[Job],
                   running: Dict[int, JobResult]) -> float:
        heap = self._heap
        while heap:
            t, _, kind, payload = heap[0]
            if t > now + 1e-12 and self._wake_valid(t, kind, payload,
                                                    running):
                break
            heapq.heappop(heap)   # already handled, or state changed
        nxt = heap[0][0] if heap else math.inf
        if self.tick and (queue or (self.speculative and running)):
            nxt = min(nxt, now + self.tick)
        return nxt

    # ------------------------------------------------------------------

    def run(self, jobs: Sequence[Job]) -> List[JobResult]:
        # a new run is a new world: bump the failure generation so any
        # cross-tick score cache (keyed by job id) starts from scratch
        # even if this simulator is reused with a different job set
        self.cluster._fail_gen += 1
        pending = sorted(jobs, key=lambda j: j.arrival)
        queue: List[Job] = []
        results: List[JobResult] = []
        running: Dict[int, JobResult] = {}
        first_attempt: Dict[int, float] = {}
        decision_time: Dict[int, float] = {}
        failures = list(self.failures)
        self._heap = []
        self._seq = itertools.count()
        self._between.clear()
        self._xfer_s.clear()
        self._handoff = []
        self.cluster.job_phase.clear()
        # overload-control state (docs/robustness.md)
        self._retry = []
        self._parked.clear()
        self._abandon = []
        self._attempts.clear()
        self._terminal.clear()
        self._feas_cache.clear()
        self.retry_events = []
        self.queue_depths = []
        self._last_pressure = -math.inf
        self._results = results
        self.cluster.link_outages = list(self.link_failures)
        self.cluster._part_memo = (None, frozenset())
        ctrl = getattr(self.policy, "overload", None)
        for job in pending:
            heapq.heappush(self._heap, (job.arrival, next(self._seq),
                                        _W_ARRIVAL, None))
        for f in failures:
            heapq.heappush(self._heap, (f.at, next(self._seq),
                                        _W_FAILURE, None))
        # slowdown edit timeline: an onset installs its factor, the
        # expiry removes it, and the worker's slowdown is recomputed as
        # the product of its still-active factors (exactly 1.0 when none
        # remain — no float residue from repeated multiply/divide)
        deg_edits: List[tuple] = []
        for k, d in enumerate(self.degradations):
            deg_edits.append((d.at, k, d.worker, d.factor))
            deg_edits.append((d.at + d.duration, k, d.worker, None))
        deg_edits.sort(key=lambda e: (e[0], e[1]))
        deg_active: Dict[str, Dict[int, float]] = {}
        for t, _, _, _ in deg_edits:
            heapq.heappush(self._heap, (t, next(self._seq),
                                        _W_FAILURE, None))
        pi = fi = di = 0         # cursors into pending / failures / edits
        now = 0.0
        n_total = len(pending)

        guard = 0
        try:
            while len(results) < n_total:
                guard += 1
                assert guard < 2_000_000, "simulator livelock"
                # 1) deliver arrivals
                while pi < len(pending) and (pending[pi].arrival
                                             <= now + 1e-12):
                    job = pending[pi]
                    pi += 1
                    queue.append(job)
                    if job.patience is not None:
                        # the client's hang-up clock starts at submission
                        # and never pauses (retry parking included)
                        t_ab = job.arrival + job.patience
                        heapq.heappush(self._abandon,
                                       (t_ab, next(self._seq), job))
                        heapq.heappush(self._heap, (t_ab, next(self._seq),
                                                    _W_ARRIVAL, None))
                    self.policy.on_arrival(job, self.cluster, now)
                # 1b) backoff re-entries that are due re-join the scan
                # queue (skipping jobs that meanwhile went terminal)
                while self._retry and self._retry[0][0] <= now + 1e-12:
                    _, _, job = heapq.heappop(self._retry)
                    if job.id not in self._parked:
                        continue
                    self._parked.discard(job.id)
                    queue.append(job)
                    self.policy.on_requeue(job, self.cluster, now)
                # 2) worker failures: kill the running job, re-queue it
                while fi < len(failures) and failures[fi].at <= now + 1e-12:
                    f = failures[fi]
                    fi += 1
                    w = self.cluster.workers[f.worker]
                    w.failed_until = f.at + f.duration
                    heapq.heappush(self._heap, (w.failed_until,
                                                next(self._seq),
                                                _W_RECOVER, f.worker))
                    for jid, rec in list(running.items()):
                        if rec.worker == f.worker and rec.end > now:
                            del running[jid]
                            w.busy_until = now
                            if self._disagg:
                                # the pool's KV state died with it: the job
                                # restarts from prefill (a decode-phase
                                # member re-prefills; partial decode tokens
                                # are discarded uncounted — ``finish`` never
                                # saw them)
                                self.cluster.job_phase[jid] = "prefill"
                                self._xfer_s.pop(jid, None)
                                self._between.pop(jid, None)
                            # checkpoint-restart: instant requeue without
                            # a retry budget, backoff park (or terminal
                            # "failed") with one
                            self._requeue_failed(rec.job, now, queue)
                    if self._disagg:
                        # pull-style staging parks the KV on a "both"
                        # prefill pool until the decode leg is admitted
                        # (the jid stays in _xfer_s); if that pool dies
                        # first, the parked cache dies with it and the
                        # (still-queued) job re-prefills.  Pushed caches
                        # already left their pool and are unaffected.
                        for jid, brec in list(self._between.items()):
                            if (brec.prefill_worker == f.worker
                                    and jid in self._xfer_s):
                                self.cluster.job_phase[jid] = "prefill"
                                del self._xfer_s[jid]
                                brec_job = self._between.pop(jid).job
                                # still queued, but its phase (and any
                                # region affinity to the dead producer)
                                # just changed under it
                                self.policy.on_requeue(brec_job,
                                                       self.cluster, now)
                    if isinstance(w, BatchedWorkerSim):
                        w.on_failure(now)
                # 2b) profile degradations: the worker keeps serving,
                # just slower than its offline characterization says —
                # running jobs keep their committed end times, new
                # dispatches (and batch admissions) pay the factor
                while di < len(deg_edits) and deg_edits[di][0] <= now + 1e-12:
                    _t, k, wname, f = deg_edits[di]
                    di += 1
                    w = self.cluster.workers.get(wname)
                    if w is None:
                        continue
                    act = deg_active.setdefault(wname, {})
                    if f is None:
                        act.pop(k, None)
                    else:
                        act[k] = f
                    s = 1.0
                    for v in act.values():
                        s *= v
                    w.slowdown = s
                # 3) complete finished jobs (running is at most one record
                # per worker in job mode and at most max_batch in batched
                # mode, so this scan is O(W), not O(jobs))
                due = [(jid, rec) for jid, rec in running.items()
                       if rec.end <= now + 1e-12]
                rebatch: Dict[str, BatchedWorkerSim] = {}
                for jid, rec in due:
                    del running[jid]
                    w = self.cluster.workers[rec.worker]
                    w.last_freed = rec.end
                    if isinstance(w, BatchedWorkerSim):
                        w.accrue(now)
                        fin = w.finish(jid)
                        rebatch[rec.worker] = w
                        if (self._disagg and
                                self.cluster.phase_of(rec.job)
                                == "prefill"):
                            # prefill done: not a completion — hand the KV
                            # off and re-queue the decode phase
                            self._handoff_prefill(jid, rec, now,
                                                  first_attempt)
                            continue
                        self._finish_streaming(rec, fin)
                    results.append(rec)
                    self.policy.on_complete(rec, self.cluster, now)
                # surviving batch members speed up (fewer sharers):
                # re-estimate their completions through the heap
                for w in rebatch.values():
                    self._rebatch(w, now, running)
                # deliver decode legs whose staging is done: parked
                # caches (handed off by the completions above from a
                # "both" pool) re-queue in this same iteration, pushed
                # ones once their transfer lands
                while self._handoff and self._handoff[0][0] <= now + 1e-12:
                    _, _, job = heapq.heappop(self._handoff)
                    if job.id in self._terminal:
                        continue     # abandoned while its KV was in flight
                    queue.append(job)
                    self.policy.on_arrival(job, self.cluster, now)
                # 3a) client abandonment: queued (or backoff-parked, or
                # handoff-staged) jobs whose patience expired hang up
                if self._abandon:
                    self._abandon_due(now, queue, running, results)
                # 3b) straggler mitigation (speculative re-dispatch)
                if self.speculative:
                    self._speculate(now, running)
                # 3c) elastic scaling
                if self.elastic_max:
                    self._elastic(now, queue)
                # 4) ask the policy for assignments
                t0 = time.perf_counter()
                assignments = self.policy.schedule(now, queue, self.cluster)
                dt = time.perf_counter() - t0
                for a in assignments:
                    decision_time[a.job.id] = (
                        decision_time.get(a.job.id, 0.0)
                        + dt / max(1, len(assignments)))
                # track blocked head-of-line attempts (scheduling overhead)
                if not assignments and queue:
                    for j in queue[:1]:
                        first_attempt.setdefault(j.id, now)
                for a in assignments:
                    self._start(a, now, queue, running, first_attempt,
                                decision_time)
                # 4b) drain the overload controller's shed decisions
                # (queued jobs the policy marked certainly-doomed or over
                # the admission cap): terminal ``outcome="shed"``
                if ctrl is not None:
                    for job in ctrl.drain():
                        if job.id in self._terminal or job.id in running:
                            continue
                        try:
                            queue.remove(job)
                        except ValueError:
                            continue    # left the queue some other way
                        results.append(
                            self._terminal_result(job, now, "shed"))
                        self.policy.on_terminal(job, self.cluster, now)
                # 4c) full-engine outage: a queued job with zero live
                # pools parks on the backoff heap until the earliest
                # recovery instead of re-entering scoring every tick.
                # Gated on retry being configured — parking shifts
                # head-of-line overhead accounting, so the historical
                # default stays bit-for-bit.
                if (not assignments and queue
                        and self.retry_budget is not None):
                    self._park_outage_victims(now, queue)
                self.queue_depths.append(len(queue))
                # 5) advance time to the next indexed wake-up
                nxt = self._next_wake(now, queue, running)
                if nxt is math.inf and not running and queue:
                    # every queued job is infeasible everywhere -> drop loudly
                    raise RuntimeError(
                        f"stuck: {[j.engine for j in queue]} infeasible")
                if nxt is math.inf:
                    break
                now = max(now, nxt)
        finally:
            self._heap = None
            self._results = None
            self.loop_iters = guard
        # settle the idle/static power floor over the run's span: parked
        # seconds burn each pool's cheapest idle draw.  Kept out of
        # ``energy_j`` (active energy, the Fig. 12 series) but it is what
        # makes "race to idle" visible in ``total_energy_j`` — fast modes
        # finish early and idle cheap instead of running long at full draw.
        span = max((r.end for r in results), default=0.0)
        for w in self.cluster.workers.values():
            w.idle_energy_j += (w.pool.idle_power_w
                                * max(0.0, span - w.busy_s))
        return results

    # ------------------------------------------------------------------
    # overload control / failure hardening (docs/robustness.md)

    def _terminal_result(self, job: Job, now: float,
                         outcome: str) -> JobResult:
        """Close a job out with a terminal non-completion outcome
        (``failed`` / ``abandoned`` / ``shed``) and release its serving
        state.  A disaggregated job keeps its prefill-leg record (that
        service really ran) with the terminal outcome stamped on it."""
        jid = job.id
        self._terminal.add(jid)
        self._parked.discard(jid)
        self._xfer_s.pop(jid, None)
        self.cluster.job_phase.pop(jid, None)
        rec = self._between.pop(jid, None)
        wait = max(0.0, now - job.arrival)
        if rec is None:
            rec = JobResult(job, "", "", now, now, wait, 0.0, wait,
                            False, 0.0, 0.0, 0.0)
        else:
            rec.end = now
            rec.e2e = wait
            rec.violated = False
            rec.excess = 0.0
        rec.outcome = outcome
        return rec

    def _park(self, job: Job, ready: float, attempt: int):
        """Put a job on the backoff heap until ``ready`` (with a matching
        event-heap wake, so the main loop never tick-scans for it)."""
        heapq.heappush(self._retry, (ready, next(self._seq), job))
        self._parked.add(job.id)
        self.retry_events.append(RetryEvent(job.id, ready, attempt))
        if self._heap is not None:
            heapq.heappush(self._heap, (ready, next(self._seq),
                                        _W_ARRIVAL, None))

    def _requeue_failed(self, job: Job, now: float, queue: List[Job]):
        """A failure killed this job's execution.  Without a retry budget
        (the historical default) it re-enters the scan queue instantly;
        with one, the re-entry backs off exponentially
        (``retry_base_s * 2^attempt``, jittered from the sim RNG) and
        budget exhaustion is terminal ``outcome="failed"``."""
        budget = (job.retry_budget if job.retry_budget is not None
                  else self.retry_budget)
        if budget is None:
            queue.append(job)
            self.policy.on_requeue(job, self.cluster, now)
            return
        att = self._attempts.get(job.id, 0)
        if att >= budget:
            self._results.append(self._terminal_result(job, now, "failed"))
            self.policy.on_terminal(job, self.cluster, now)
            return
        self._attempts[job.id] = att + 1
        delay = self.retry_base_s * (2.0 ** att)
        if self.retry_jitter:
            delay *= 1.0 + self.retry_jitter * float(self.rng.random())
        self._park(job, now + delay, att + 1)

    def _abandon_due(self, now: float, queue: List[Job],
                     running: Dict[int, JobResult],
                     results: List[JobResult]):
        """Expired-patience sweep.  A job abandons while queued, parked
        on the backoff heap, or staged between disaggregated phases; a
        running batched member abandons only before its first decoded
        token (the client saw nothing yet) — it leaves the batch without
        counting tokens and the survivors speed up.  Jobs already
        streaming (or in exclusive job-mode service) are committed."""
        while self._abandon and self._abandon[0][0] <= now + 1e-12:
            _, _, job = heapq.heappop(self._abandon)
            jid = job.id
            if jid in self._terminal:
                continue
            if jid in running:
                rec = running[jid]
                w = self.cluster.workers.get(rec.worker)
                if isinstance(w, BatchedWorkerSim) and jid in w.active:
                    w.accrue(now)
                    f = w.active.get(jid)
                    if f is not None and f.prefill_done_at is None:
                        w.abandon(jid)
                        del running[jid]
                        results.append(
                            self._terminal_result(job, now, "abandoned"))
                        self.policy.on_terminal(job, self.cluster, now)
                        self._rebatch(w, now, running)
                continue
            in_queue = any(q.id == jid for q in queue)
            staged = jid in self._between       # KV handoff in flight
            if not (in_queue or jid in self._parked or staged):
                continue                        # already completed
            if in_queue:
                queue[:] = [q for q in queue if q.id != jid]
            results.append(self._terminal_result(job, now, "abandoned"))
            self.policy.on_terminal(job, self.cluster, now)

    def _feasible_pools(self, engine: str) -> List[str]:
        # feasibility is static per (engine, fleet membership): clones
        # share their base pool's profile rows
        key = (engine, self.cluster._member_gen,
               self.policy.use_default_config)
        hit = self._feas_cache.get(key)
        if hit is None:
            use_default = self.policy.use_default_config
            hit = self._feas_cache[key] = [
                n for n in self.cluster.workers
                if self.cluster.feasible(engine, n, use_default)]
        return hit

    def _park_outage_victims(self, now: float, queue: List[Job]):
        """Full-engine outage parking: a queued job every one of whose
        feasible pools is failed parks on the backoff heap until the
        earliest recovery (no budget consumed — nothing *killed* it), so
        a dead engine costs O(1) wakes instead of a tick-scan per second
        of outage."""
        until: Dict[str, float] = {}
        for job in list(queue):
            t = until.get(job.engine)
            if t is None:
                t = 0.0
                names = self._feasible_pools(job.engine)
                if names:
                    workers = self.cluster.workers
                    t = math.inf
                    for n in names:
                        fu = workers[n].failed_until
                        if fu <= now:
                            t = 0.0      # a live pool exists
                            break
                        t = min(t, fu)
                    if t is math.inf:    # engine feasible nowhere: leave
                        t = 0.0          # queued so "stuck" still trips
                until[job.engine] = t
            if t > now:
                queue.remove(job)
                self._park(job, t + 1e-9,
                           self._attempts.get(job.id, 0))

    def _speculate(self, now: float, running: Dict[int, "JobResult"]):
        use_default = self.policy.use_default_config
        for jid, rec in list(running.items()):
            if rec.speculated or rec.end <= now:
                continue
            ent = (self.cd.default_entry(rec.job.engine, rec.worker)
                   if use_default else
                   self.cd.optimal(rec.job.engine, rec.worker))
            est = exec_time(ent, rec.job.queries)
            if now - rec.start < 1.5 * est:
                continue  # not (yet) a straggler
            # find the fastest idle worker that could beat the laggard
            best = None
            for w in self.cluster.idle_workers(now):
                ent2 = (self.cd.default_entry(rec.job.engine, w)
                        if use_default else
                        self.cd.optimal(rec.job.engine, w))
                if ent2 is None or ent2.qps <= 0:
                    continue
                end2 = now + exec_time(ent2, rec.job.queries)
                if end2 < rec.end and (best is None or end2 < best[1]):
                    best = (w, end2, ent2)
            if best is None:
                continue
            w2, end2, ent2 = best
            ws_old = self.cluster.workers[rec.worker]
            ws_new = self.cluster.workers[w2]
            # the backup wins: cancel the original at the backup's finish
            ws_old.busy_until = end2
            # refund the cancelled tail [end2, rec.end) that was billed in
            # full at dispatch — the original worker frees at end2, so
            # keeping its busy_s/energy_j would charge those seconds twice
            # (once here, once on the backup)
            saved = rec.end - end2
            ws_old.busy_s -= saved
            ws_old.energy_j -= ent.power_w * saved
            # the original worker's free time is no longer tied to the
            # job's completion record (which now lives on the backup): if a
            # failure later kills the backup, the completion wake becomes
            # stale but this worker still frees at end2 — index that wake
            # independently, like the legacy loop's busy_until rescan does
            self._notify_worker_free(rec.worker, end2)
            ws_new.busy_until = end2
            ws_new.last_assigned = now
            ws_new.n_jobs += 1
            extra = end2 - now
            ws_new.busy_s += extra
            ws_new.energy_j += ent2.power_w * extra
            rec.end = end2
            rec.e2e = end2 - rec.job.arrival
            rec.exec_s = end2 - rec.start
            rec.violated = rec.e2e > rec.job.t_qos
            rec.excess = max(0.0, rec.e2e - rec.job.t_qos)
            rec.worker = w2
            rec.config = f"{ent2.mode}/r{ent2.chips_per_replica}"
            rec.speculated = True
            # streaming metrics follow the winning (backup) execution,
            # which restarts the job from its prefill at ``now``
            from repro_torch.core.serving_bridge import prefill_prefix
            base = exec_time(ent2, rec.job.queries)
            pre = prefill_prefix(ent2, rec.job.queries)
            first_s = (pre / base) * extra if base > 0 else 0.0
            rec.ttft = (now - rec.job.arrival) + first_s
            dtok = self._decode_tokens(rec.job)
            rec.tpot = (extra - first_s) / dtok if dtok > 0 else math.nan
            self._apply_stream_deadlines(rec)
            self._notify_end_changed(rec.job.id, end2)

    def _elastic_base(self, now: float) -> "WorkerPool":
        """The pool to clone.  Region-tagged fleets scale the *hottest*
        region: pick the region with the highest busy/failed fraction
        right now, then its strongest pool — so the clone inherits the
        pressured region's tag and joins that region's scheduling columns
        instead of bulking up a cold one.  Untagged (or single-region)
        fleets reduce to the historical global argmax, bit-for-bit (ties:
        first in fleet order, exactly like ``max``)."""
        workers = list(self.cluster.workers.values())
        regions = {w.pool.region for w in workers}
        if len(regions) > 1:
            stats: Dict[str, List[float]] = {}  # region -> [busy, total]
            for w in workers:
                s = stats.setdefault(w.pool.region, [0.0, 0.0])
                s[0] += float(w.busy_until > now or w.failed_until > now)
                s[1] += 1.0
            best_r, best_load = None, -1.0
            for r, (busy, total) in stats.items():   # insertion order
                load = busy / total
                if load > best_load:
                    best_r, best_load = r, load
            workers = [w for w in workers if w.pool.region == best_r]
        return max(workers, key=lambda w: w.pool.chip_flops
                   * w.pool.n_chips).pool

    def _elastic(self, now: float, queue: List[Job]):
        """Spin up a clone of the strongest pool (of the hottest region,
        when the fleet is region-tagged) when the queue backs up
        (provisioning delay applies); retire idle clones once pressure
        subsides.  Only clones created here are ever retired, so synthetic
        fleet members (also named ``base__k``) are left alone."""
        if len(queue) >= self.elastic_threshold:
            self._last_pressure = now       # hysteresis clock restarts
        if (len(queue) >= self.elastic_threshold
                and self._clones < self.elastic_max):
            self._clones += 1
            self.elastic_clones_total += 1
            base = self._elastic_base(now)
            # reuse retired slot numbers (bounded by elastic_max) so the
            # estimator's per-worker-tuple row cache cycles through a small
            # set of keys instead of growing with every provision
            slot = 1
            while any(n.endswith(f"__clone{slot}")
                      for n in self._clone_names):
                slot += 1
            name = f"{base.name}__clone{slot}"
            clone = self.cluster._make_worker(base)
            clone.busy_until = now + self.provision_s
            self.cluster.workers[name] = clone
            self._clone_names.append(name)
            self._notify_worker_free(name, clone.busy_until)
        elif (not queue
              and now - self._last_pressure >= self.elastic_cooldown_s):
            # scale-down hysteresis: the pressure trigger must have been
            # quiet for the cooldown window (0.0 default = retire as soon
            # as the queue drains, the historical behavior)
            for name in list(self._clone_names):
                ws = self.cluster.workers[name]
                # a batched clone is "idle" whenever it has a free slot —
                # only retire it once its batch has fully drained
                if ws.idle(now) and not getattr(ws, "active", None):
                    del self.cluster.workers[name]
                    self._clone_names.remove(name)
                    self._clones -= 1
                    self.elastic_retires_total += 1

    def _start(self, a: Assignment, now: float, queue, running,
               first_attempt, decision_time):
        w = self.cluster.workers[a.worker]
        if isinstance(w, BatchedWorkerSim):
            self._start_batched(a, w, now, queue, running, first_attempt,
                                decision_time)
            return
        assert w.idle(now), f"{a.worker} busy"
        queue.remove(a.job)
        pred_s = exec_time(a.entry, a.job.queries)
        exec_s = pred_s * w.slowdown
        if self.exec_noise:
            s = self.exec_noise
            exec_s *= float(self.rng.lognormal(-0.5 * s * s, s))
        if self.straggler_prob and self.rng.random() < self.straggler_prob:
            exec_s *= self.straggler_factor
        solo_s = exec_s
        if a.xfer_s:
            # cross-region placement: the input ships over the REGION_XFER
            # link before service starts (deterministic — not noise-scaled)
            exec_s += a.xfer_s
        start = now
        end = start + exec_s
        w.busy_until = end
        w.last_assigned = now
        w.n_jobs += 1
        w.busy_s += exec_s
        if a.xfer_s:
            # the compute seconds bill at the entry's draw, the WAN-transfer
            # prefix at the idle/static floor (the chips wait on the wire)
            w.energy_j += (a.entry.power_w * (exec_s - a.xfer_s)
                           + a.entry.idle_power_w * a.xfer_s)
        else:
            w.energy_j += a.entry.power_w * exec_s
        waiting = start - a.job.arrival
        e2e = end - a.job.arrival
        overhead = now - first_attempt.get(a.job.id, now)
        rec = JobResult(a.job, a.worker, f"{a.entry.mode}/r"
                        f"{a.entry.chips_per_replica}", start, end, waiting,
                        exec_s, e2e, e2e > a.job.t_qos,
                        max(0.0, e2e - a.job.t_qos), overhead,
                        decision_time.get(a.job.id, 0.0))
        rec.service_s = solo_s
        rec.service_pred_s = pred_s
        self._job_mode_streaming(rec, a.entry, exec_s, xfer_s=a.xfer_s)
        running[a.job.id] = rec
        self._notify_end_changed(a.job.id, end)

    # ------------------------------------------------------------------
    # streaming QoS (TTFT / TPOT)

    def _decode_tokens(self, job: Job) -> int:
        """Decoded-token count behind a job's TPOT: its ``Request``, or
        the engine-default shape (matching ``default_request``)."""
        if job.request is not None:
            return job.request.decode_tokens
        spec = self._engines.get(job.engine)
        return job.queries * spec.decode_len if spec is not None else 0

    def _job_mode_streaming(self, rec: JobResult, entry, exec_s: float,
                            xfer_s: float = 0.0):
        """TTFT/TPOT for exclusive job-level service: the profiled
        prefill share of the (noisy) execution time marks the first
        token; noise and stragglers stretch both phases alike.  A
        cross-region shipping prefix (``Assignment.xfer_s``, already in
        ``exec_s``) precedes the prefill, delaying the first token by its
        full length."""
        from repro_torch.core.serving_bridge import prefill_prefix
        job = rec.job
        base = exec_time(entry, job.queries)
        if xfer_s:
            exec_s -= xfer_s
        first_s = xfer_s
        pre = prefill_prefix(entry, job.queries)
        first_s += (pre / base) * exec_s if base > 0 else 0.0
        rec.ttft = rec.waiting + first_s
        dtok = self._decode_tokens(job)
        rec.tpot = (exec_s - first_s) / dtok if dtok > 0 else math.nan
        self._apply_stream_deadlines(rec)

    def _apply_stream_deadlines(self, rec: JobResult):
        """Fold TTFT/TPOT deadline misses into the violation flags (NaN
        metrics never violate; jobs without deadlines are untouched)."""
        req = rec.job.request
        if req is None:
            return
        rec.ttft_violated = (req.ttft_qos is not None
                             and rec.ttft > req.ttft_qos)
        rec.tpot_violated = (req.tpot_qos is not None
                             and rec.tpot > req.tpot_qos)
        if rec.ttft_violated or rec.tpot_violated:
            rec.violated = True

    def _finish_streaming(self, rec: JobResult, fin: Optional[_InFlight]):
        """Final streaming metrics for a completed batched job.  Under
        disaggregation ``rec.ttft`` was pinned at prefill handoff and the
        transfer + decode-queue time lands in TPOT; otherwise the first
        token is the member's interpolated prefill crossing."""
        if fin is not None:
            if not math.isnan(rec.ttft):      # disaggregated: set at handoff
                first = rec.job.arrival + rec.ttft
            else:
                first = (fin.prefill_done_at
                         if fin.prefill_done_at is not None else rec.end)
                rec.ttft = first - rec.job.arrival
            dtok = self._decode_tokens(rec.job)
            rec.tpot = ((rec.end - first) / dtok if dtok > 0 else math.nan)
        self._apply_stream_deadlines(rec)

    # ------------------------------------------------------------------
    # serving bridge (serving="batched"): continuous-batching service

    def _start_batched(self, a: Assignment, w: BatchedWorkerSim,
                       now: float, queue, running, first_attempt,
                       decision_time):
        from repro_torch.core.serving_bridge import (batch_profile,
                                               default_request,
                                               kv_transfer_s, solo_service)
        if (not w.can_admit(a.job.engine, now)
                or not self.cluster.role_ok(a.job, a.worker)):
            # the policy raced the batch-formation rules (engine mismatch,
            # KV/slot budget, or phase-role); the job stays queued
            first_attempt.setdefault(a.job.id, now)
            return
        phase = (self.cluster.job_phase.get(a.job.id, "prefill")
                 if self._disagg else "full")
        if phase == "decode":
            brec = self._between.get(a.job.id)
            pws = (self.cluster.workers.get(brec.prefill_worker)
                   if brec is not None else None)
            if (pws is not None and a.worker != brec.prefill_worker
                    and pws.pool.region != w.pool.region
                    and self.cluster.link_down(pws.pool.region,
                                               w.pool.region, now)):
                # WAN partition: the cross-region KV pull dies on the
                # severed link and the parked cache is unreachable — the
                # in-flight handoff is lost and the job restarts from
                # prefill under its retry budget
                queue.remove(a.job)
                self.cluster.job_phase[a.job.id] = "prefill"
                self._xfer_s.pop(a.job.id, None)
                self._between.pop(a.job.id, None)
                self._requeue_failed(a.job, now, queue)
                return
        queue.remove(a.job)
        spec = self._engines[a.job.engine]
        prof = batch_profile(a.entry, spec, w.pool)
        req = a.job.request
        work, prefill = solo_service(a.entry, prof, req, a.job.queries)
        full_req = req or default_request(spec, a.job.queries)
        if phase == "prefill":
            # prefill-only slice of the service (preproc + prompt pass);
            # the member's first token *is* its phase completion
            work = prefill
            track_req = Request(full_req.prompt_tokens, 0)
        elif phase == "decode":
            work, prefill = work - prefill, 0.0
            track_req = Request(0, full_req.decode_tokens)
        else:
            track_req = full_req
        pred_s = work
        # the same noise model as job-level serving, in the same op order
        # (forcing max_batch=1 reproduces job mode bit-for-bit)
        work *= w.slowdown
        prefill *= w.slowdown
        if self.exec_noise:
            s = self.exec_noise
            noise = float(self.rng.lognormal(-0.5 * s * s, s))
            work *= noise
            prefill *= noise
        if self.straggler_prob and self.rng.random() < self.straggler_prob:
            work *= self.straggler_factor
            prefill *= self.straggler_factor
        solo_s = work
        wire_s = 0.0               # WAN/handoff seconds billed at idle floor
        if a.xfer_s:
            # cross-region placement: the input ships over the REGION_XFER
            # link first.  Deterministic link time — not noise-scaled —
            # and it precedes the prefill, so the first token waits on it.
            work += a.xfer_s
            wire_s += a.xfer_s
            if phase != "decode":
                prefill += a.xfer_s
        if phase == "decode":
            # a cache parked on a "both" pool (pull-style staging) is
            # fetched now that the placement is known — free when the
            # decode leg lands back on the pool that prefilled it (the
            # cache never moves).  The pull heads the member's service (a
            # contended batch stretches it like any service seconds) but
            # is not noise-scaled: link time is deterministic.  Pushed
            # caches paid the link before re-queueing (xfer is 0 here).
            xfer = self._xfer_s.pop(a.job.id, 0.0)
            pw = self._between[a.job.id].prefill_worker
            if a.worker != pw:
                work += xfer
                wire_s += xfer
                # a decode leg pulling its cache from another *region*
                # pays the WAN surcharge on top of the in-region handoff
                pws = self.cluster.workers.get(pw)
                if (pws is not None
                        and pws.pool.region != w.pool.region):
                    from repro_torch.core.serving_bridge import \
                        region_xfer_extra_s
                    extra = region_xfer_extra_s(prof)
                    work += extra
                    wire_s += extra
        w.accrue(now)
        w.admit(now, a.job.id, a.job.engine, a.entry, prof, track_req,
                work, prefill)
        if wire_s:
            w.xfer_debt_s += wire_s
        w.last_assigned = now
        w.n_jobs += 1
        start = now
        end = start + work
        config = f"{a.entry.mode}/r{a.entry.chips_per_replica}"
        if phase == "decode":
            # second leg of a disaggregated job: extend the record opened
            # at prefill (exec_s spans prefill start -> decode end, i.e.
            # it includes the KV transfer and any decode queueing).  The
            # handoff cleared this job's first_attempt entry, so blocked
            # decode attempts and decode-round decisions accumulate on
            # top of the prefill leg's overhead.
            rec = self._between.pop(a.job.id)
            rec.worker = a.worker
            rec.config = config
            rec.end = end
            rec.exec_s = end - rec.start
            rec.e2e = end - a.job.arrival
            rec.violated = rec.e2e > a.job.t_qos
            rec.excess = max(0.0, rec.e2e - a.job.t_qos)
            rec.overhead_s += now - first_attempt.get(a.job.id, now)
            rec.decision_s = decision_time.get(a.job.id, 0.0)
            rec.service_s = (solo_s if math.isnan(rec.service_s)
                             else rec.service_s + solo_s)
            rec.service_pred_s = (pred_s if math.isnan(rec.service_pred_s)
                                  else rec.service_pred_s + pred_s)
        else:
            waiting = start - a.job.arrival
            e2e = end - a.job.arrival
            overhead = now - first_attempt.get(a.job.id, now)
            rec = JobResult(a.job, a.worker, config, start, end, waiting,
                            work, e2e, e2e > a.job.t_qos,
                            max(0.0, e2e - a.job.t_qos), overhead,
                            decision_time.get(a.job.id, 0.0))
            rec.service_s = solo_s
            rec.service_pred_s = pred_s
            if phase == "prefill":
                self._xfer_s[a.job.id] = kv_transfer_s(prof)
        running[a.job.id] = rec
        self._notify_end_changed(a.job.id, end)
        # joining slows the whole batch down: re-estimate everyone
        self._rebatch(w, now, running)

    def _handoff_prefill(self, jid: int, rec: JobResult, now: float,
                         first_attempt: Dict[int, float]):
        """Prefill phase of a disaggregated job finished: record TTFT
        (the prefill pool produced the first token), stage the KV cache,
        and re-queue the decode phase.

        Staging is role-aware.  A ``prefill``-only pool can never win the
        decode leg, so its cache is *pushed* eagerly — the transfer
        overlaps the re-queue and the decode leg arrives once it lands
        (the pre-pull behavior, bit-for-bit).  A ``role="both"`` pool
        might decode the job itself, so its cache is *parked* (the jid
        stays in ``self._xfer_s``) and the decode leg queues immediately;
        the pull is charged at decode admission, and costs nothing when
        the leg lands back on the producing pool.  The job's
        blocked-attempt clock restarts so the decode leg's scheduling
        overhead accrues on top of the prefill leg's."""
        first_attempt.pop(jid, None)
        rec.ttft = rec.end - rec.job.arrival
        rec.prefill_worker = rec.worker
        self.cluster.job_phase[jid] = "decode"
        self._between[jid] = rec
        ready = now
        if self.cluster.workers[rec.worker].pool.role != "both":
            ready += self._xfer_s.pop(jid, 0.0)       # push eagerly
        heapq.heappush(self._handoff, (ready, next(self._seq), rec.job))
        if ready > now and self._heap is not None:
            heapq.heappush(self._heap, (ready, next(self._seq),
                                        _W_ARRIVAL, None))

    def _rebatch(self, w: BatchedWorkerSim, now: float,
                 running: Dict[int, JobResult]):
        """Batch membership changed: re-estimate every member's completion
        at the new sharing multiplier and re-index the changed wakes
        (``accrue`` must have brought the batch up to ``now`` first)."""
        m = w.multiplier()
        ends = []
        for f in w.active.values():
            end = now + f.remaining_s / m
            ends.append(end)
            rec = running[f.jid]
            if rec.end != end:
                rec.end = end
                rec.exec_s = end - rec.start
                rec.e2e = end - rec.job.arrival
                rec.violated = rec.e2e > rec.job.t_qos
                rec.excess = max(0.0, rec.e2e - rec.job.t_qos)
                self._notify_end_changed(f.jid, end)
        # full batch: policies' backlog view is the earliest slot-free
        # time; otherwise the worker can admit right away
        w.busy_until = now if w._has_slot() else min(ends)
