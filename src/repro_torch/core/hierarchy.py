# Port of repro/core/hierarchy.py: the same numpy code, imports rewritten to repro_torch.
"""Two-level hierarchical scheduling: a global region router over
per-region SynergAI cores (ROADMAP "planetary-scale fleets").

The flat scheduler scores every queued job against every pool — even
incrementally (``docs/performance.md``) the per-tick work is linear in
total fleet width W.  PerLLM's edge-cloud collaborative placement
(arXiv:2405.14636) argues the deployable shape is hierarchical: a cheap
constrained upper level routes work between resource *groups*, and the
expensive architecture-aware scoring runs only within a group.  This
module is that split for SynergAI:

* ``RegionRouter`` — the upper level.  It keeps O(k) per-region
  aggregates (per-engine capacity from the shared estimator row tables,
  failure health from the fleet arrays, observed queue pressure, a
  drift-adjusted EWMA of the arriving engine mix) and routes each
  arriving job to a region in O(k).  No per-pool state is touched.
* ``RegionView`` — a read-only facade over one region's slice of a
  ``Cluster``: the struct-of-arrays vector views (availability, busy
  wait, depth penalty, admission) recomputed over the region's columns,
  and a region-interned worker token whose estimator table is a *column
  slice* of the full-fleet table (``estimator.register_region_table`` —
  the region never re-profiles or re-gathers rows the flat table holds).
  An unmodified ``SynergAI`` scheduled against a view behaves exactly as
  if the region were the whole cluster.
* ``HierarchicalSynergAI`` — the policy.  Arrivals are routed
  (``on_arrival``), the queue is partitioned by home region each tick,
  and one persistent per-region ``SynergAI`` (with its own cross-tick
  ``ScoreCache`` over region-sliced rows) places its own partition.
  Failure requeues drop the job's home so it re-routes against live
  aggregates (``on_requeue``).

**Cross-region spillover.**  A region whose partition outruns its open
slots may place its overflow on another region's idle pools — but a
spilled job ships its input over the inter-region WAN first
(``serving_bridge.job_region_xfer_s``, the REGION_XFER link model), so a
spill is taken only when the estimate *plus* the transfer still meets
the job's deadline.  The surcharge rides on ``Assignment.xfer_s`` and is
charged by the simulator as a deterministic service prefix (it delays
the first token).  Disaggregated decode legs never pay it here: crossing
regions at decode moves the KV cache instead, and the simulator charges
that WAN surcharge (``region_xfer_extra_s``) at decode admission.

**Flat equivalence.**  With one region (or an untagged fleet, which is
one ``""`` region) the policy delegates wholesale to a single flat
``SynergAI`` against the real cluster: no routing, no views, no
transfers — the schedule is bit-for-bit identical to flat SynergAI
(``tests/test_hierarchy.py`` pins the PR 2/PR 4 golden digests).

**Invalidation.**  Views and router are rebuilt when the cluster's
membership generation moves; the per-region sub-schedulers (and their
score caches) persist across rebuilds, so an elastic clone appended to
one region extends only that region's cached columns while every other
region's cache stays warm (same serial, same region worker tuple, same
failure generation).  Any failure bumps the shared ``fail_gen`` and
flushes every region's cache — the same conservative rule as flat.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.estimator import engine_rows, register_region_table
from repro_torch.core.job import Job
from repro_torch.core.scheduler import SynergAI
from repro_torch.core.simulator import PHASE_CODE, Assignment, Cluster, Policy

# EWMA horizon for the router's drift-adjusted engine mix: once the
# total count passes this, every count is halved (recent traffic weighs
# ~2x the previous window — cheap, deterministic decay).
_MIX_HALF = 512


class _RegionArrays:
    """The ``names``/``index`` face of ``_FleetArrays`` for one region —
    what ``ScoreCache.sync`` and the placement loops read."""

    __slots__ = ("names", "index")

    def __init__(self, names: List[str]):
        self.names = names
        self.index = {n: i for i, n in enumerate(names)}


class RegionView:
    """One region's slice of a ``Cluster``, duck-typed to the scheduler-
    facing read API (``avail_array`` .. ``admit_engine_mask``,
    ``arrays``, ``serial``/``worker_token``/``fail_gen``).  Every vector
    view replicates the cluster's expression over the region's columns —
    pure comparisons on the same values, so the masks equal the global
    masks sliced, bit-for-bit.  Never mutates the cluster."""

    def __init__(self, cluster: Cluster, region: str, idx,
                 profile: int = 0):
        self._c = cluster
        self.region = region
        self._idx = np.asarray(idx, dtype=np.intp)
        a = cluster.arrays
        self.arrays = _RegionArrays([a.names[i] for i in self._idx])
        self.cd = cluster.cd
        self.serving = cluster.serving
        self.disaggregated = cluster.disaggregated
        # a (cluster, region) pair is a stable cache identity: rebuilt
        # views of the same region keep it, so region score caches
        # survive fleet growth elsewhere
        self.serial = (cluster.serial, region)
        self.worker_token = register_region_table(
            cluster.cd, a.names, self._idx, use_default=False,
            token=cluster.worker_token, profile=profile)

    # -- cache identity -------------------------------------------------

    @property
    def fail_gen(self) -> int:
        return self._c.fail_gen

    # -- serving-bridge delegates --------------------------------------

    def phase_of(self, job: Job) -> str:
        return self._c.phase_of(job)

    # -- vectorized scheduler views over the region's columns ----------

    def avail_array(self, now: float) -> np.ndarray:
        a = self._c.arrays
        i = self._idx
        free = (a.busy_until[i] <= now) & (a.failed_until[i] <= now)
        if self.serving == "batched":
            d = a.depth[i]
            free &= (d == 0) | (d < a.slot_cap[i])
        return free

    def busy_wait_array(self, now: float) -> np.ndarray:
        a = self._c.arrays
        i = self._idx
        return np.maximum(0.0, np.maximum(a.busy_until[i] - now,
                                          a.failed_until[i] - now))

    def depth_penalty_array(self, now: float) -> np.ndarray:
        a = self._c.arrays
        i = self._idx
        pen = np.ones(len(i))
        if self.serving == "batched":
            d = a.depth[i]
            m = ((d > 0) & (a.busy_until[i] <= now)
                 & (a.failed_until[i] <= now) & (d < a.slot_cap[i]))
            if m.any():
                pen[m] = 1.0 + a.alpha[i][m] * d[m]
        return pen

    def admit_engine_mask(self, engine: str, now: float,
                          phase: str = "full") -> np.ndarray:
        a = self._c.arrays
        i = self._idx
        ok = (a.busy_until[i] <= now) & (a.failed_until[i] <= now)
        if self.disaggregated:
            r = a.role[i]
            ok &= (r == 0) | (r == PHASE_CODE[phase])
        if self.serving == "batched":
            d = a.depth[i]
            ok &= (d == 0) | (d < a.slot_cap[i])
            eid = self._c._engine_code.get(engine, -2)
            e = a.engine_id[i]
            ok &= (e == -1) | (e == eid)
        return ok

    # -- router aggregates ---------------------------------------------

    def health(self, now: float) -> float:
        """Fraction of the region's pools not currently failed — the
        router's failure aggregate.  A correlated regional outage drives
        this to 0.0 on the next refresh (one tick), draining the region
        from the routing scores."""
        a = self._c.arrays
        return float((a.failed_until[self._idx] <= now).mean())

    @property
    def roles(self) -> np.ndarray:
        """[W_r] ROLE_CODE per pool (0 == "both") — the router's
        phase-aware capacity mask under disaggregated fleets."""
        return self._c.arrays.role[self._idx]


class RegionRouter:
    """O(k) upper level: per-region aggregates + deterministic routing.

    A job routes to the region minimizing ``(pressure + 1) / (health *
    capacity)`` — queued work per unit of *healthy, mix-weighted*
    throughput — over regions that can serve its engine at all.
    ``capacity`` blends the job's own engine capacity with the
    drift-adjusted mix capacity (an EWMA of the arriving engine mix, so
    a popularity drift re-weights routing without re-profiling).  Ties
    break at the lowest region index; a fully-failed feasible set falls
    back to ignoring health (the jobs must queue somewhere)."""

    def __init__(self, cd, views: Dict[str, RegionView], carbon=None):
        self.cd = cd
        self.views = views
        # optional workload.CarbonTrace: routing scores are weighted by
        # each region's relative grid intensity at decision time, so the
        # router prefers clean-grid regions long before any per-worker
        # scoring happens (None: carbon-blind, bit-for-bit historical)
        self._carbon = carbon
        self._cw: Optional[np.ndarray] = None    # [k] relative intensity
        self._cw_t: Optional[float] = None
        self.regions: List[str] = list(views)
        self._ri = {r: i for i, r in enumerate(self.regions)}
        k = len(self.regions)
        self.home: Dict[int, str] = {}       # job id -> routed region
        self.pressure = np.zeros(k)          # queued jobs seen this tick
        self.healthy = np.ones(k)            # live-pool fraction
        self._cap: Dict[tuple, np.ndarray] = {}  # (engine, phase) -> [k]
        self._counts: Dict[str, float] = {}      # EWMA engine mix
        self._cmix: Optional[np.ndarray] = None  # [k] mix-weighted cap

    def capacity(self, engine: str, phase: str = "full") -> np.ndarray:
        """[k] aggregate feasible throughput (sum of optimal-config qps)
        per region for one engine, from the shared region row tables —
        computed once per (engine, phase, fleet generation).  Under
        disaggregated fleets a ``prefill``/``decode`` phase masks pools
        whose role can't serve it, so a job is never homed to a region
        that could not run its current phase at all."""
        key = (engine, phase)
        cap = self._cap.get(key)
        if cap is None:
            vals = np.empty(len(self.regions))
            for i, v in enumerate(self.views.values()):
                qps = engine_rows(self.cd, engine, v.arrays.names,
                                  token=v.worker_token)[0]
                if phase != "full":
                    roles = v.roles
                    qps = qps * ((roles == 0)
                                 | (roles == PHASE_CODE[phase]))
                vals[i] = qps.sum()
            cap = self._cap[key] = vals
        return cap

    def refresh(self, now: float):
        """Per-tick aggregate update: failure health per region, the
        drift-adjusted mix capacity, and a pressure reset (the partition
        pass rebuilds it from the live queue)."""
        for i, r in enumerate(self.regions):
            self.healthy[i] = self.views[r].health(now)
        self._carbon_w(now)
        self.pressure[:] = 0.0
        total = sum(self._counts.values())
        if total > 0.0:
            cm = np.zeros(len(self.regions))
            for e, c in self._counts.items():
                cm += (c / total) * self.capacity(e)
            self._cmix = cm
        else:
            self._cmix = None

    def _carbon_w(self, now: Optional[float]):
        """[k] relative region carbon intensities at ``now`` (None
        without a trace); memoized per timestamp — ``route`` reuses the
        tick's vector across a whole partition pass."""
        if self._carbon is None:
            return None
        if now is not None and now != self._cw_t:
            self._cw = np.fromiter(
                (self._carbon.relative(r, now) for r in self.regions),
                dtype=np.float64, count=len(self.regions))
            self._cw_t = now
        return self._cw

    def route(self, job: Job, phase: str = "full",
              now: Optional[float] = None) -> str:
        """Pick a home region for ``job``'s current phase (O(k)), pin
        it, and fold the engine into the drift mix.  With a CarbonTrace
        attached, the pressure-per-capacity score is weighted by each
        region's relative intensity at ``now`` — a region on a 2x-dirty
        grid must look 2x better on load to win the job."""
        cap = self.capacity(job.engine, phase)
        blend = (cap if self._cmix is None
                 else 0.5 * cap + 0.5 * self._cmix)
        denom = self.healthy * blend
        ok = (cap > 0) & (denom > 0)
        if not ok.any():
            # every feasible region is down — ignore health; an engine
            # feasible nowhere just takes region 0 (it is doomed anyway)
            ok = cap > 0
            denom = np.maximum(cap, 1e-30)
        if ok.any():
            safe = np.where(ok, denom, 1.0)    # denom > 0 wherever ok
            score = np.where(ok, (self.pressure + 1.0) / safe, np.inf)
            cw = self._carbon_w(now)
            if cw is not None:
                score = score * cw             # inf stays inf: cw > 0
            ri = int(score.argmin())
        else:
            ri = 0
        r = self.regions[ri]
        self.home[job.id] = r
        c = self._counts
        c[job.engine] = c.get(job.engine, 0.0) + 1.0
        if sum(c.values()) > _MIX_HALF:
            for e in c:
                c[e] *= 0.5
        return r

    def note(self, region: str):
        """Count one queued job toward ``region``'s pressure this tick
        (called by the partition pass, so mid-tick routing decisions see
        the backlog accumulated ahead of them)."""
        self.pressure[self._ri[region]] += 1.0

    def blocked(self, region: str, cluster: Cluster,
                now: float) -> Optional[np.ndarray]:
        """[k] bool mask of regions whose WAN link to ``region`` is
        currently severed (``cluster.partitioned_pairs``), or ``None``
        when no partition touches ``region`` — the spillover pass must
        not ship input (or pull KV) across a down link."""
        pairs = cluster.partitioned_pairs(now)
        if not pairs:
            return None
        blk = np.zeros(len(self.regions), dtype=bool)
        hit = False
        for i, r2 in enumerate(self.regions):
            if r2 != region and frozenset((region, r2)) in pairs:
                blk[i] = True
                hit = True
        return blk if hit else None


class HierarchicalSynergAI(Policy):
    """Two-level SynergAI: ``RegionRouter`` over per-region ``SynergAI``
    cores scheduled against ``RegionView`` slices.  With one region (or
    an untagged fleet) delegates wholesale to a single flat ``SynergAI``
    on the real cluster — bit-for-bit the flat schedule."""

    name = "SynergAI-H"
    use_default_config = False

    def __init__(self, score_fn=None, incremental: bool = True,
                 spill: bool = True, recharacterizer=None,
                 energy_weight: float = 0.0, carbon=None,
                 overload=None):
        self._score_fn = score_fn
        self._incremental = incremental
        self.spill = spill
        # one shared OverloadController consulted by every per-region
        # sub-core: each region sheds against its own partition (so
        # ``queue_cap`` is a per-region bound), the marks pool in the
        # shared controller, and the simulator drains them once per tick.
        # None (default) keeps every historical schedule bit-for-bit.
        self.overload = overload
        # the same energy/carbon knob as flat SynergAI, applied at both
        # levels: every per-region core scores with ``energy_weight`` (and
        # its region's intensity via the CarbonTrace), and the router's
        # O(k) aggregates are carbon-weighted so routing itself prefers
        # clean-grid regions.  0.0 is bit-for-bit the energy-blind
        # hierarchy.
        if energy_weight < 0:
            raise ValueError("energy_weight must be >= 0")
        self.energy_weight = float(energy_weight)
        self.carbon = carbon
        # one shared recharacterizer: each region feeds its own drift
        # detector window (observe_arrival(region=...)), any region's
        # trigger runs the single global refresh, and every sub-core's
        # score cache reads the same profile overlay
        self.recharacterizer = recharacterizer
        self.profile = recharacterizer.profile if recharacterizer else 0
        self.router: Optional[RegionRouter] = None
        self._views: Dict[str, RegionView] = {}
        self._subs: Dict[str, SynergAI] = {}
        self._rid: Optional[np.ndarray] = None   # [W] region index
        self._sig = None
        self.spills = 0          # introspection: cross-region placements

    def _sub(self, region: str) -> SynergAI:
        sub = self._subs.get(region)
        if sub is None:
            sub = self._subs[region] = SynergAI(
                score_fn=self._score_fn, incremental=self._incremental,
                recharacterizer=self.recharacterizer,
                energy_weight=self.energy_weight, carbon=self.carbon,
                overload=self.overload)
        return sub

    def _ensure(self, cluster: Cluster):
        sig = (cluster.serial, cluster._member_gen)
        if sig == self._sig:
            return
        groups: Dict[str, List[int]] = {}
        for i, ws in enumerate(cluster.workers.values()):
            groups.setdefault(ws.pool.region, []).append(i)
        self._views = {r: RegionView(cluster, r, idx, profile=self.profile)
                       for r, idx in groups.items()}
        rid = np.empty(len(cluster.workers), dtype=np.intp)
        for ri, idx in enumerate(groups.values()):
            rid[idx] = ri
        self._rid = rid
        old = self.router
        self.router = RegionRouter(
            cluster.cd, self._views,
            carbon=self.carbon if self.energy_weight else None)
        if old is not None:
            # homes and the drift mix survive a fleet change; stale
            # homes of vanished regions re-route at next sighting
            self.router.home = old.home
            self.router._counts = old._counts
        self._sig = sig

    # -- simulator hooks ------------------------------------------------

    def on_arrival(self, job: Job, cluster: Cluster, now: float):
        self._ensure(cluster)
        if len(self._views) > 1 and job.id not in self.router.home:
            self.router.route(job, cluster.phase_of(job), now)
        if self.recharacterizer is not None:
            # per-region drift windows: each region's traffic mix is
            # tracked against its own anchor, so a mix flip confined to
            # one region triggers without diluting into the global mix
            region = (self.router.home.get(job.id, "")
                      if len(self._views) > 1 else "")
            self.recharacterizer.observe_arrival(job, cluster, now,
                                                 region=region)

    def on_complete(self, result, cluster, now):
        if self.recharacterizer is not None:
            self.recharacterizer.observe_complete(
                result, cluster, now, use_default=self.use_default_config)

    def on_requeue(self, job: Job, cluster: Cluster, now: float):
        self._ensure(cluster)
        if len(self._views) > 1:
            # the home region may have just failed — re-route against
            # live aggregates when the job is next seen
            self.router.home.pop(job.id, None)

    def on_terminal(self, job: Job, cluster: Cluster, now: float):
        # a shed/abandoned/failed job never re-enters any queue: reclaim
        # its score-cache row in whichever region core held it (release
        # is a no-op elsewhere) and drop its routing home
        for sub in self._subs.values():
            sub.on_terminal(job, cluster, now)
        if self.router is not None:
            self.router.home.pop(job.id, None)

    # -- the tick --------------------------------------------------------

    def schedule(self, now, queue, cluster: Cluster) -> List[Assignment]:
        if not queue:
            return []
        self._ensure(cluster)
        if len(self._views) <= 1:
            # flat equivalence: one region is just flat SynergAI on the
            # real cluster (no routing, no views, no transfers)
            region = next(iter(self._views), "")
            return self._sub(region).schedule(now, queue, cluster)
        router = self.router
        router.refresh(now)
        disagg = cluster.disaggregated
        parts: Dict[str, List[Job]] = {r: [] for r in router.regions}
        # pressure accumulates in a plain Python list (a numpy scalar
        # add per queued job is ~20x slower) and is flushed to the
        # router only when a routing decision actually reads it
        rix = router._ri
        pcount = [0.0] * len(router.regions)
        capok: Dict[tuple, bool] = {}
        for j in queue:
            phase = cluster.phase_of(j) if disagg else "full"
            r = router.home.get(j.id)
            if r is not None:
                if r not in parts:
                    r = None            # vanished region: re-route
                elif disagg:
                    key = (j.engine, phase, r)
                    ok = capok.get(key)
                    if ok is None:
                        ok = capok[key] = bool(
                            router.capacity(j.engine, phase)[rix[r]] > 0)
                    if not ok:
                        # a phase advance the home can't serve (e.g.
                        # its only decode pools live elsewhere)
                        r = None
            if r is None:
                router.pressure[:] = pcount
                r = router.route(j, phase, now)
            parts[r].append(j)
            pcount[rix[r]] += 1.0
        router.pressure[:] = pcount
        out: List[Assignment] = []
        placed = set()
        for r in router.regions:
            part = parts[r]
            if not part:
                continue
            for a in self._sub(r).schedule(now, part, self._views[r]):
                out.append(a)
                placed.add(a.job.id)
        if self.spill:
            self._spillover(now, cluster, parts, placed, out, disagg)
        for a in out:
            if not disagg or cluster.phase_of(a.job) == "decode":
                # terminal placement: the job will not re-enter the
                # queue (short of a failure, which re-routes anyway)
                router.home.pop(a.job.id, None)
        return out

    # per-tick global budget of per-job spill scans: overflow relief is
    # bounded so a deep standing backlog cannot turn the spill pass into
    # a second full scoring sweep (each scan is a W-wide numpy pass)
    SPILL_SCAN = 64

    def _spillover(self, now, cluster, parts, placed, out, disagg):
        """Overflow relief: a region whose open slots cannot serve its
        leftover jobs' phase may place its overflow on other regions'
        idle pools — charged the REGION_XFER input transfer, and only
        when the estimate plus the transfer still meets the deadline (a
        hopeless spill would burn a remote slot for a violation).

        Slot-starvation is judged per (engine, phase) from a memoized
        [k] mask of regions holding an open slot that *admits* that
        engine and phase: a job whose home region has one keeps waiting
        — its sub-scheduler left the slot open *by choice* (doomed-wait,
        batch engine lock), and spilling would second-guess it.  The
        memo makes the home check O(1) per job; the per-job foreign
        scan is capped at ``SPILL_SCAN`` W-wide passes per tick,
        most-urgent first, so relief cost stays bounded under deep
        backlogs.  The remote estimate uses the full-service row (a
        deliberate heuristic under disaggregation: spill is overload
        relief, the exact phase split stays a region-local concern)."""
        from repro_torch.core.serving_bridge import job_region_xfer_s
        router = self.router
        index = cluster.arrays.index
        names = cluster.arrays.names
        rid = self._rid
        open_slots = cluster.avail_array(now).copy()
        for a in out:
            open_slots[index[a.worker]] = False
        if not open_slots.any():
            return
        batched = cluster.serving == "batched"
        cd = cluster.cd
        k = len(router.regions)
        # memo: (engine, phase) -> [k] "region holds an open slot that
        # admits this engine+phase" (invalidated when a spill consumes
        # a slot) — the O(1)-per-job home-starvation check
        home_ok: Dict[tuple, np.ndarray] = {}
        budget = self.SPILL_SCAN
        for r in router.regions:
            ri = router._ri[r]
            left = [j for j in parts[r] if j.id not in placed]
            if not left:
                continue
            # WAN partitions sever the REGION_XFER link: regions cut off
            # from this home take no spill (input could not ship, and a
            # decode leg could not pull its KV back across the link)
            rblk = router.blocked(r, cluster, now)
            wblk = rblk[rid] if rblk is not None else None
            if len(left) > budget:
                left = sorted(left, key=lambda j: j.t_qos
                              - (now - j.arrival))[:budget]
            for j in left:
                phase = cluster.phase_of(j) if disagg else "full"
                key = (j.engine, phase)
                ok = home_ok.get(key)
                if ok is None:
                    m = open_slots & (engine_rows(
                        cd, j.engine, names,
                        token=cluster.worker_token)[0] > 0)
                    if batched:
                        m &= cluster.admit_engine_mask(j.engine, now,
                                                       phase)
                    ok = home_ok[key] = \
                        np.bincount(rid[m], minlength=k) > 0
                if ok[ri]:
                    # home still has an open slot this job could use —
                    # it is waiting by its sub-scheduler's choice
                    continue
                if budget <= 0 or not open_slots.any():
                    return
                budget -= 1
                qps, pre, _ = engine_rows(cd, j.engine, names,
                                          token=cluster.worker_token)
                with np.errstate(divide="ignore", invalid="ignore"):
                    t = np.where(qps > 0,
                                 pre + float(j.queries) / qps, np.inf)
                elig = open_slots & np.isfinite(t) & (rid != ri)
                if wblk is not None:
                    elig &= ~wblk
                if batched:
                    elig &= cluster.admit_engine_mask(
                        j.engine, now, cluster.phase_of(j))
                if not elig.any():
                    continue
                # decode legs ship KV, not input — the simulator charges
                # that WAN surcharge at admission; don't charge both
                xfer = 0.0 if phase == "decode" else job_region_xfer_s(j)
                cand = np.where(elig, t, np.inf)
                wi = int(cand.argmin())
                if cand[wi] + xfer > j.t_qos - (now - j.arrival):
                    continue        # would violate even if it ran now
                w = names[wi]
                out.append(Assignment(j, w, cd.optimal(j.engine, w),
                                      xfer_s=xfer))
                placed.add(j.id)
                open_slots[wi] = False
                home_ok.clear()      # the consumed slot may back a memo
                self.spills += 1
                if disagg and phase == "prefill":
                    # the KV cache will live where the prefill ran —
                    # point the decode leg's home at it
                    router.home[j.id] = router.regions[rid[wi]]
