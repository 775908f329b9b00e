# Port of repro/core/scheduler.py: the same numpy code, imports rewritten to repro_torch.
"""SynergAI online scheduler (paper §4.2).

QoS-aware run-time scheduling: the queue is continuously re-scored with the
vectorized Eq. 1-4 estimator, ordered by urgency (descending risk), doomed
jobs are de-prioritized to the tail, and each dequeued job walks its sorted
(worker, c*) candidate list to the first available worker.  A periodic
update (simulator tick) reassesses all waiting jobs.

Unlike every baseline, assignments use the *optimal* per-(engine, worker)
configuration c*_{j,w} from the offline Configuration Dictionary.

The hot path is **incremental across ticks** (docs/performance.md): a
``repro.core.scorecache.ScoreCache`` persists each job's Eq. 2 row —
``t_estimated`` is time-invariant per (job, worker-set) — so a tick only
recomputes the time-decaying quantities (``t_remaining``, urgency, doom)
as O(J) vector ops, appends rows for arrivals, extends columns on elastic
provisioning, and flushes on fleet-generation changes.  Per-worker state
(availability, backlog, batch depth, admission) reads the ``Cluster``
struct-of-arrays mirror as O(W) vector ops instead of Python loops.  On
the plain path placement is *lazy*: candidate rows are evaluated in
urgency order only until the open slots are filled, so the per-tick cost
stays sublinear in queue depth (the PerLLM deployability argument,
arXiv:2405.14636).  ``SynergAI(incremental=False)`` preserves the
full-matrix path; both produce bit-for-bit identical schedules
(``tests/test_scorecache.py``, plus the pinned golden digests).

The placement pass is fully vectorized for fleet scale (thousands of queued
jobs x hundreds of pools): per-job candidate walks become masked argmins
over a shared cost matrix — provably the same assignment as walking the
stable-sorted candidate list, since ``argmin`` breaks ties at the lowest
worker index exactly like a stable sort does.  ``score_fn`` swaps the
scoring backend: the numpy estimator by default, the Eq. 2-4 Pallas kernel
via ``repro.core.pallas_scoring.make_pallas_score_fn()``, or the fused v2
kernel (``make_pallas_score_fn(v2=True)``) that additionally folds the
batched depth penalty, the prefill/decode phase split and the TTFT/TPOT
streaming gates into one on-accelerator pass.

Under the batched serving bridge (``Simulator(..., serving="batched")``)
the estimates become *queue-depth-aware*: every worker's column is scaled
by ``Cluster.depth_penalty`` (joining a batch of ``b`` members runs
``1 + alpha * b`` slower than solo), acceptability and doom are
re-derived from the adjusted times, and eligibility is intersected with
the bridge's batch-formation rules (same-engine batches under slot/KV
budgets) via ``Cluster.admit_engine_mask``.

Streaming QoS (``Request.ttft_qos`` / ``tpot_qos``) tightens the gate
further: acceptability requires the *tighter* of the end-to-end, TTFT and
TPOT headrooms to survive (``estimator.phase_split_matrices`` supplies the
prefill/decode split of Eq. 2), and a scarce TTFT budget can become the
binding urgency.  Under prefill/decode-disaggregated pools
(``WorkerPool.role``) each phase is placed independently: phase-sliced
service times, role-gated eligibility.  With no deadlines and no role
tags every addition is inert and the schedule is unchanged bit-for-bit.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.engines import engine_catalogue
from repro_torch.core.estimator import (energy_matrix, estimate_matrix,
                                  phase_split_matrices)
from repro_torch.core.scorecache import ScoreCache
from repro_torch.core.simulator import (PHASE_CODE, PHASE_NAME, Assignment,
                                  Cluster, Policy)


class SynergAI(Policy):
    name = "SynergAI"
    use_default_config = False

    def __init__(self, score_fn=None, incremental: bool = True,
                 recharacterizer=None, energy_weight: float = 0.0,
                 carbon=None, overload=None):
        # score_fn: optional accelerated scorer — the Eq. 2-4 Pallas
        # kernel, or the fused v2 kernel (``fused`` attribute) which also
        # consumes the depth penalty / phase split / streaming gates.
        # incremental=False disables the cross-tick score cache (the
        # uncached reference path, e.g. for the perf bench baseline).
        # recharacterizer: an ``OnlineRecharacterizer`` closing the
        # offline/online loop — arrivals and completions feed its drift
        # detector, and scoring reads its belief-scaled profile overlay
        # (``estimator.ProfileOverlay``); inert until it triggers.
        # energy_weight: seconds of estimated latency traded per joule of
        # estimated job energy — the weighted energy/carbon term added to
        # Eq. 4's placement cost (``docs/performance.md``).  Acceptability
        # and doom stay purely time-derived (Eq. 1-3 untouched), so the
        # term steers choices *among* a job's acceptable open workers and
        # never parks a job to save energy.  0.0 (default) is bit-for-bit
        # the energy-blind scheduler: no energy rows are ever built.
        # carbon: optional ``workload.CarbonTrace`` — scales each worker's
        # energy term by its region's *relative* grid intensity at
        # decision time, making the term a carbon term.
        # overload: an ``overload.OverloadController`` — deadline-aware
        # load shedding (the cached certain-doom predicate) + queue-depth
        # admission backpressure, consulted on every scoring pass; the
        # simulator drains its marks into terminal ``outcome="shed"``
        # results.  None (default) is bit-for-bit the shed-free scheduler.
        if energy_weight < 0:
            raise ValueError("energy_weight must be >= 0")
        self.energy_weight = float(energy_weight)
        self.carbon = carbon
        self.overload = overload
        self._regions_key = None
        self._regions: tuple = ()
        self.score_fn = score_fn or estimate_matrix
        self._fused = bool(getattr(score_fn, "fused", False))
        self._device = bool(getattr(score_fn, "device_cache", False))
        self._takes_token = bool(getattr(self.score_fn, "takes_token",
                                         False))
        self._takes_profile = bool(getattr(self.score_fn, "takes_profile",
                                           False))
        self.recharacterizer = recharacterizer
        self.profile = recharacterizer.profile if recharacterizer else 0
        if (recharacterizer is not None and score_fn is not None
                and not (self._fused or self._takes_profile)):
            raise ValueError(
                "recharacterizer needs a score_fn that reads the profile "
                "overlay: the default numpy estimator, the fused v2 "
                "kernel, or a backend advertising takes_profile")
        # a conventional custom score_fn builds its own matrices, so the
        # row cache would be dead weight; the fused kernel reads its
        # matrices *from* the cache, so it always carries one; the
        # device-resident backend carries the device-mirrored subclass
        if self._device:
            from repro_torch.core.devicecache import DeviceScoreCache
            self.cache: Optional[ScoreCache] = DeviceScoreCache(
                profile=self.profile,
                bj=getattr(score_fn, "bj", 128),
                device=getattr(score_fn, "device", None))
        else:
            self.cache = (
                ScoreCache(profile=self.profile) if self._fused
                or (incremental and score_fn is None) else None)

    # -- online re-characterization hooks (inert without one) ----------

    def on_arrival(self, job, cluster, now):
        if self.recharacterizer is not None:
            self.recharacterizer.observe_arrival(job, cluster, now)

    def on_complete(self, result, cluster, now):
        if self.recharacterizer is not None:
            self.recharacterizer.observe_complete(
                result, cluster, now,
                use_default=self.use_default_config)

    def on_terminal(self, job, cluster, now):
        # reclaim-on-shed: the job never returns, free its cached row now
        if self.cache is not None:
            self.cache.release(job.id)

    def schedule(self, now, queue, cluster: Cluster) -> List[Assignment]:
        if not queue:
            return []
        avail = cluster.avail_array(now)
        if not avail.any():
            # nothing can start this tick; scoring the whole queue would
            # change no assignment (the placement below only dispatches
            # onto idle workers), so skip the scoring pass — the dominant
            # cost under fleet-scale backlog.  Overload control must keep
            # shedding here, though: a fully-busy fleet is exactly when
            # the queue grows, so run the O(J) doom/backpressure pass
            # against the cached minima without placing anything.
            if self.overload is not None and self.cache is not None:
                self._shed_only(now, queue, cluster)
            return []
        if self.cache is not None:
            return self._schedule_cached(now, queue, cluster, avail)
        return self._schedule_full(now, queue, cluster, avail)

    # ------------------------------------------------------------------
    # incremental path (default): cached rows + O(J) time decay

    def _schedule_cached(self, now, queue, cluster, avail):
        cd = cluster.cd
        cache = self.cache
        slots = cache.sync(cd, queue, cluster)
        t_rem = cache.t_remaining(slots, now)
        batched = getattr(cluster, "serving", "job") == "batched"
        disagg = getattr(cluster, "disaggregated", False)
        has_ttft = cache.has_ttft(slots)
        has_tpot = cache.has_tpot(slots)
        streaming = bool(has_ttft.any() or has_tpot.any())
        pen = (cluster.depth_penalty_array(now) if batched
               else np.ones(len(avail)))
        penalized = batched and bool((pen != 1.0).any())
        if streaming or disagg:
            cache.ensure_phase_rows(cd, queue, slots, cluster)
        ew = self.energy_weight
        if ew:
            cache.ensure_energy_rows(cd, queue, slots, cluster)
        if self._device:
            return self._schedule_device(now, queue, cluster, avail, slots,
                                         t_rem, pen, has_ttft, has_tpot,
                                         batched, disagg)
        if self._fused:
            return self._schedule_fused(now, queue, cluster, avail, slots,
                                        t_rem, pen, has_ttft, has_tpot,
                                        batched, disagg, streaming)
        if not (disagg or streaming):
            # the plain tick: every cached row is still exact, so only
            # Eq. 1's decay moves — urgency and doom are O(J) vector ops
            # (doomed == "no acceptable worker" == t_rem < min_w t_est)
            # and placement walks rows lazily until the slots are filled.
            # The batched depth penalty only *scales* columns (pen >= 1),
            # so doom stays decidable from the cached row minima for
            # almost every job: t_rem < min_est dooms certainly, and a
            # penalty-free argmin column acquits certainly; only jobs
            # whose cheapest worker currently runs a live batch gather
            # their row — incremental depth-penalty columns, never the
            # full [J, W] rebuild.
            min_est = cache.min_estimate(slots)
            urgency = t_rem - min_est
            doomed = t_rem < min_est
            # the shed consult uses exactly this pre-refinement mask:
            # pen >= 1 only inflates estimates, so t_rem < min_est is
            # certain doom under any batch depth — O(1) per shed against
            # the cached minima
            shed = (self.overload.consult(now, queue, doomed, urgency)
                    if self.overload is not None else None)
            if penalized:
                unsure = ~doomed & (pen[cache.argmin_estimate(slots)]
                                    != 1.0)
                if unsure.any():
                    ui = np.nonzero(unsure)[0]
                    rows = cache.t_matrix(slots[ui]) * pen[None, :]
                    doomed[ui] = ~(t_rem[ui, None] >= rows).any(axis=1)
            return self._place_lazy(now, queue, cluster, avail, cache,
                                    slots, t_rem, urgency, doomed, batched,
                                    pen if penalized else None,
                                    self._carbon_scale(cluster, now)
                                    if ew else None, skip=shed)
        # phases / deadlines re-derive the whole matrix from the cached
        # rows (still no ConfigDict gathers, no per-job Python)
        t = cache.t_matrix(slots)
        phase = np.zeros(len(queue), dtype=np.int8)
        if streaming or disagg:
            pre_m, dec_m = cache.phase_matrices(slots)
        if disagg:
            phase = np.fromiter(
                (PHASE_CODE[cluster.phase_of(j)] for j in queue),
                dtype=np.int8, count=len(queue))
            t = np.where((phase == 1)[:, None], pre_m,
                         np.where((phase == 2)[:, None], dec_m, t))
        if penalized:
            t = t * pen[None, :]
        acceptable = t_rem[:, None] >= t
        urgency = t_rem - cache.min_estimate(slots)
        if streaming:
            wait = cache.waiting(slots, now)
            ttft_qos = cache.ttft_qos(slots)
            tpot_qos = cache.tpot_qos(slots)
            dtok = cache.dtok(slots)
            ttft_rem = ttft_qos - wait
            ttft_est = pre_m * pen[None, :]
            tpot_est = dec_m * pen[None, :] / dtok[:, None]
            ok_ttft = ((~has_ttft | (phase == 2))[:, None]
                       | (ttft_est <= ttft_rem[:, None]))
            ok_tpot = ((~has_tpot | (phase == 1))[:, None]
                       | (tpot_est <= tpot_qos[:, None]))
            acceptable = acceptable & ok_ttft & ok_tpot
            with np.errstate(invalid="ignore"):
                ttft_slack = ttft_rem - np.min(ttft_est, axis=1)
            urgency = np.where(has_ttft & (phase != 2),
                               np.minimum(urgency, ttft_slack), urgency)
        doomed = ~acceptable.any(axis=1)
        # streaming/disaggregated shed predicate: "no acceptable worker
        # at all" (deadline gates folded in) — the path's own doom mask
        shed = (self.overload.consult(now, queue, doomed, urgency)
                if self.overload is not None else None)
        return self._place(now, queue, cluster, avail, t, acceptable,
                           urgency, doomed, batched, phase,
                           self._energy_cost(cache, slots, cluster, now)
                           if ew else None, skip=shed)

    def _shed_only(self, now, queue, cluster):
        """No open slot this tick, but the controller still sheds: decay
        the cached estimates and consult with the certain-doom mask (the
        same O(J) quantities the plain tick uses)."""
        cache = self.cache
        slots = cache.sync(cluster.cd, queue, cluster)
        t_rem = cache.t_remaining(slots, now)
        min_est = cache.min_estimate(slots)
        self.overload.consult(now, queue, t_rem < min_est, t_rem - min_est)

    # -- the weighted energy/carbon term -------------------------------

    def _carbon_scale(self, cluster, now):
        """[W] relative grid carbon intensity of each worker's region at
        ``now`` (None without a CarbonTrace — the term is pure energy)."""
        if self.carbon is None:
            return None
        region = getattr(cluster, "region", None)
        if region is not None:          # a hierarchy RegionView: uniform
            return np.full(len(cluster.arrays.names),
                           self.carbon.relative(region, now))
        key = (cluster.serial, cluster.worker_token)
        if key != self._regions_key:
            self._regions = tuple(
                cluster.workers[n].pool.region
                for n in cluster.arrays.names)
            self._regions_key = key
        return self.carbon.relative_for(self._regions, now)

    def _energy_cost(self, cache, slots, cluster, now):
        """[J, W] additive placement-cost term: weight x estimated job
        joules (x relative region carbon when a trace is attached)."""
        ecost = self.energy_weight * cache.energy_matrix(slots)
        scale = self._carbon_scale(cluster, now)
        if scale is not None:
            ecost = ecost * scale[None, :]
        return ecost

    def _place_lazy(self, now, queue, cluster, avail, cache, slots, t_rem,
                    urgency, doomed, batched, pen=None, cscale=None,
                    skip=None):
        """Order by (urgency, doomed) and evaluate candidate rows one at
        a time, stopping once every open slot is filled — identical
        assignments to the full masked-argmin pass (same per-row
        expressions, same tie-breaks), without materializing [J, W].
        ``pen`` (batched depth penalties, or None when every batch is
        empty) scales each row exactly like the full path's
        ``t * pen[None, :]``.  With ``energy_weight`` set, each row's
        ranking cost additionally carries the job's cached energy row
        (``cscale``: per-worker relative carbon, or None) — eligibility
        and doom stay time-derived."""
        order = np.lexsort((urgency, doomed))
        ew = self.energy_weight
        busy_wait = (cluster.busy_wait_array(now) if doomed.any()
                     else None)
        emask = {} if batched else None
        names = cluster.arrays.names
        cd = cluster.cd
        out: List[Assignment] = []
        open_slots = avail.copy()
        n_open = int(open_slots.sum())
        for ji in order:
            if skip is not None and skip[ji]:
                continue        # marked shed: the simulator drains it
            row = cache.row(slots[ji])
            if pen is not None:
                row = row * pen
            if doomed[ji]:
                feas = np.isfinite(row)
                cost = row + busy_wait
                best = np.where(feas, cost, np.inf).min()
                elig = feas & (row <= 1.5 * best)
            else:
                cost = row
                elig = t_rem[ji] >= row
            if ew:
                erow = cache.energy_row(slots[ji])
                cost = cost + (ew * erow if cscale is None
                               else ew * erow * cscale)
            open_row = open_slots
            if batched:
                eng = queue[ji].engine       # phase is "full" on this path
                m = emask.get(eng)
                if m is None:
                    m = emask[eng] = cluster.admit_engine_mask(eng, now)
                open_row = open_slots & m
            cand = np.where(open_row & elig, cost, np.inf)
            wi = int(cand.argmin())
            if np.isfinite(cand[wi]):
                w = names[wi]
                job = queue[ji]
                out.append(Assignment(job, w,
                                      cd.optimal(job.engine, w)))
                open_slots[wi] = False
                n_open -= 1
                if n_open == 0:
                    break
        return out

    # ------------------------------------------------------------------
    # device-resident path: the cache's row pools already live on the
    # accelerator, so the whole decision — gather by slot, the fused
    # scoring kernel, the urgency-ordered greedy placement — runs as one
    # ``scheduler_tick`` dispatch; the host ships only O(J + W) vectors
    # and reads back (job, worker) indices

    def _schedule_device(self, now, queue, cluster, avail, slots, t_rem,
                         pen, has_ttft, has_tpot, batched, disagg):
        cache = self.cache
        phase = np.zeros(len(queue), dtype=np.int8)
        if disagg:
            phase = np.fromiter(
                (PHASE_CODE[cluster.phase_of(j)] for j in queue),
                dtype=np.int8, count=len(queue))
        # Eq. 1 decay stays a float64 host op over the cached scalars
        # (the f32 cast of `now` itself would lose precision long before
        # the budgets do); everything [J, W]-shaped stays on-device
        ttft_rem = cache.ttft_qos(slots) - cache.waiting(slots, now)
        if batched:
            keys = {}
            masks = []
            ekey = np.empty(len(queue), np.int32)
            for qi, j in enumerate(queue):
                k = (j.engine, int(phase[qi]))
                ki = keys.get(k)
                if ki is None:
                    ki = keys[k] = len(masks)
                    masks.append(cluster.admit_engine_mask(
                        j.engine, now, PHASE_NAME[k[1]]))
                ekey[qi] = ki
            emask = np.stack(masks)
        else:
            ekey = np.zeros(len(queue), np.int32)
            emask = np.ones((1, len(avail)), bool)
        escale = None
        if self.energy_weight:
            cscale = self._carbon_scale(cluster, now)
            escale = self.energy_weight * (
                cscale if cscale is not None else np.ones(len(avail)))
        assign, order = cache.device_tick(
            slots, t_rem, ttft_rem, cache.tpot_qos(slots),
            cache.dtok(slots), has_ttft, has_tpot, phase, ekey, emask,
            pen, cluster.busy_wait_array(now), avail, escale)
        # overload control on the device path: the kernel has already
        # placed, so the host-side consult (cached certain-doom mask)
        # only filters the emitted assignments — a shed job's slot idles
        # one tick, which is the price of keeping the kernel unchanged
        shed = None
        if self.overload is not None:
            min_est = cache.min_estimate(slots)
            shed = self.overload.consult(now, queue, t_rem < min_est,
                                         t_rem - min_est)
        names = cluster.arrays.names
        cd = cluster.cd
        J = len(queue)
        out: List[Assignment] = []
        for ji in order:        # same emit order as _place's sorted walk
            if ji >= J:
                continue
            if shed is not None and shed[ji]:
                continue
            wi = int(assign[ji])
            if wi >= 0:
                job = queue[ji]
                out.append(Assignment(job, names[wi],
                                      cd.optimal(job.engine, names[wi])))
        return out

    # ------------------------------------------------------------------
    # fused Pallas path: depth penalty + phase split + streaming gates
    # run inside the kernel; the cache supplies its input matrices

    def _schedule_fused(self, now, queue, cluster, avail, slots, t_rem,
                        pen, has_ttft, has_tpot, batched, disagg,
                        streaming):
        cache = self.cache
        t0 = cache.t_matrix(slots)
        if streaming or disagg:
            pre_m, dec_m = cache.phase_matrices(slots)
        else:
            pre_m = dec_m = t0      # gates are off: placeholders
        phase = np.zeros(len(queue), dtype=np.int8)
        if disagg:
            phase = np.fromiter(
                (PHASE_CODE[cluster.phase_of(j)] for j in queue),
                dtype=np.int8, count=len(queue))
        ttft_rem = cache.ttft_qos(slots) - cache.waiting(slots, now)
        t, acceptable, urgency, doomed = self.score_fn(
            t0, pre_m, dec_m, t_rem, pen, phase, has_ttft, has_tpot,
            ttft_rem, cache.tpot_qos(slots), cache.dtok(slots))
        shed = (self.overload.consult(now, queue, doomed, urgency)
                if self.overload is not None else None)
        return self._place(now, queue, cluster, avail, t, acceptable,
                           urgency, doomed, batched, phase,
                           self._energy_cost(cache, slots, cluster, now)
                           if self.energy_weight else None, skip=shed)

    # ------------------------------------------------------------------
    # reference path: full [J, W] rebuild every tick (incremental=False,
    # or a conventional custom score_fn)

    def _schedule_full(self, now, queue, cluster, avail):
        workers = cluster.arrays.names
        kw = {}
        if self._takes_token:
            kw["token"] = cluster.worker_token
        if self._takes_profile and self.profile:
            kw["profile"] = self.profile
        score = self.score_fn(cluster.cd, queue, workers, now,
                              use_default=False, **kw)
        t = score.t_estimated
        doomed = score.doomed
        acceptable = score.acceptable
        urgency = score.urgency
        t_rem = score.t_remaining
        batched = getattr(cluster, "serving", "job") == "batched"
        disagg = getattr(cluster, "disaggregated", False)
        reqs = [j.request for j in queue]
        has_ttft = np.fromiter((r is not None and r.ttft_qos is not None
                                for r in reqs), dtype=bool, count=len(reqs))
        has_tpot = np.fromiter((r is not None and r.tpot_qos is not None
                                for r in reqs), dtype=bool, count=len(reqs))
        streaming = bool(has_ttft.any() or has_tpot.any())
        changed = False
        pen = np.ones(len(workers))
        phase = np.zeros(len(queue), dtype=np.int8)   # PHASE_CODE values
        if disagg or streaming:
            pre_m, dec_m = phase_split_matrices(cluster.cd, queue, workers,
                                                use_default=False,
                                                token=cluster.worker_token,
                                                profile=self.profile)
        if disagg:
            # phase-aware service times: a prefill-phase job costs a
            # worker only its prefill prefix, a decode-phase job only the
            # decode remainder (the handoff already happened)
            phase = np.fromiter(
                (PHASE_CODE[cluster.phase_of(j)] for j in queue),
                dtype=np.int8, count=len(queue))
            t = np.where((phase == 1)[:, None], pre_m,
                         np.where((phase == 2)[:, None], dec_m, t))
            changed = True
        if batched:
            # queue-depth-adjusted latency: joining a live batch divides
            # the job's service rate; re-derive Eq. 3/4 from the
            # penalized estimates (identical to the plain path whenever
            # every batch is empty, e.g. max_batch=1 with free workers)
            pen = cluster.depth_penalty_array(now)
            if (pen != 1.0).any():
                t = t * pen[None, :]
                changed = True
        if changed:
            acceptable = t_rem[:, None] >= t
        if streaming:
            # gate on the tighter of (latency, TTFT, TPOT) headroom: a
            # worker is acceptable only if every deadline the job carries
            # survives its estimates.  The TTFT budget decays with waiting
            # like t_remaining; TPOT is a pure rate constraint.  A decode-
            # phase job's TTFT is already history, a prefill-phase job's
            # TPOT belongs to its later decode placement.
            engines = engine_catalogue()
            wait = np.fromiter((now - j.arrival for j in queue),
                               dtype=np.float64, count=len(queue))
            ttft_qos = np.array([r.ttft_qos if r is not None and
                                 r.ttft_qos is not None else np.inf
                                 for r in reqs])
            tpot_qos = np.array([r.tpot_qos if r is not None and
                                 r.tpot_qos is not None else np.inf
                                 for r in reqs])
            # per-token rate uses the engine-default token count (dec_m
            # is the profile-shape decode time, so the ratio is exactly
            # the simulator's solo decode_frac/(qps*decode_len) — the
            # sampled Request length cancels out of a per-token metric)
            dtok = np.array([float(j.queries * engines[j.engine].decode_len)
                             if j.engine in engines
                             else (float(r.decode_tokens)
                                   if r is not None and r.decode_tokens > 0
                                   else np.inf)
                             for j, r in zip(queue, reqs)])
            ttft_rem = ttft_qos - wait
            ttft_est = pre_m * pen[None, :]
            tpot_est = dec_m * pen[None, :] / dtok[:, None]
            ok_ttft = ((~has_ttft | (phase == 2))[:, None]
                       | (ttft_est <= ttft_rem[:, None]))
            ok_tpot = ((~has_tpot | (phase == 1))[:, None]
                       | (tpot_est <= tpot_qos[:, None]))
            acceptable = acceptable & ok_ttft & ok_tpot
            # a tight TTFT can be the binding urgency even when the e2e
            # budget is comfortable
            with np.errstate(invalid="ignore"):
                ttft_slack = ttft_rem - np.min(ttft_est, axis=1)
            urgency = np.where(has_ttft & (phase != 2),
                               np.minimum(urgency, ttft_slack), urgency)
            changed = True
        if changed:
            doomed = ~acceptable.any(axis=1)
        ecost = None
        if self.energy_weight:
            ecost = self.energy_weight * energy_matrix(
                cluster.cd, queue, workers, use_default=False,
                token=cluster.worker_token, profile=self.profile)
            scale = self._carbon_scale(cluster, now)
            if scale is not None:
                ecost = ecost * scale[None, :]
        shed = (self.overload.consult(now, queue, doomed, urgency)
                if self.overload is not None else None)
        return self._place(now, queue, cluster, avail, t, acceptable,
                           urgency, doomed, batched, phase, ecost,
                           skip=shed)

    # ------------------------------------------------------------------
    # shared placement tail (full-matrix variant)

    def _place(self, now, queue, cluster, avail, t, acceptable, urgency,
               doomed, batched, phase, ecost=None, skip=None):
        # order: urgent first (2D Ordered Job Queue); doomed jobs last.
        # lexsort is stable, so ties keep queue order like sorted() did.
        order = np.lexsort((urgency, doomed))
        # per-job candidate cost + eligibility (the sorted (w, c*) list):
        # non-doomed jobs walk their *acceptable* workers by T_estimated;
        # doomed jobs minimize expected completion (wait + exec) over all
        # feasible workers, restricted to options within 1.5x of the best
        # so a doomed job waits for a fast worker instead of seizing a far
        # slower idle one and blocking it for everyone else.
        feasible = np.isfinite(t)
        if doomed.any():
            busy_wait = cluster.busy_wait_array(now)
            cost = np.where(doomed[:, None], t + busy_wait[None, :], t)
            best_cost = np.where(feasible, cost, np.inf).min(axis=1)
            elig = np.where(doomed[:, None],
                            feasible & (t <= 1.5 * best_cost[:, None]),
                            acceptable)
        else:
            cost = t
            elig = acceptable
        if ecost is not None:
            # the weighted energy/carbon term joins the *ranking* cost
            # only — eligibility, doom and the doomed 1.5x gate above are
            # already fixed from the time estimates
            cost = cost + ecost
        if batched:
            # batch-formation rules: a live batch only admits its own
            # engine, under the slot and KV budgets — and, under
            # disaggregated pools, the phase-role match (one O(W) vector
            # mask per distinct (engine, phase) key, reusing the phase
            # codes computed above instead of re-deriving them per job)
            emask = {}
            rows = []
            for qi, j in enumerate(queue):
                k = (j.engine, int(phase[qi]))
                m = emask.get(k)
                if m is None:
                    m = emask[k] = cluster.admit_engine_mask(
                        j.engine, now, PHASE_NAME[k[1]])
                rows.append(m)
            elig = elig & np.stack(rows)
        ranked = np.where(elig, cost, np.inf)
        # jobs with no eligible idle worker can never place this round
        live = np.isfinite(ranked[:, avail]).any(axis=1)

        names = cluster.arrays.names
        cd = cluster.cd
        out: List[Assignment] = []
        open_slots = avail.copy()
        n_open = int(open_slots.sum())
        for ji in order:
            if not live[ji] or (skip is not None and skip[ji]):
                continue
            cand = np.where(open_slots, ranked[ji], np.inf)
            wi = int(cand.argmin())
            if np.isfinite(cand[wi]):
                w = names[wi]
                job = queue[ji]
                out.append(Assignment(job, w, cd.optimal(job.engine, w)))
                open_slots[wi] = False
                n_open -= 1
                if n_open == 0:
                    break
        return out
