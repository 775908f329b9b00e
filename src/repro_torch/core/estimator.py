# Port of repro/core/estimator.py: the same numpy code, imports rewritten to repro_torch.
"""Execution Time Estimator + QoS Violation Detection (paper Eq. 1-4),
vectorized over the (jobs x workers) matrix.

The numpy path is authoritative; ``repro.kernels.scheduler_score`` is the
TPU Pallas version of the same scoring used at fleet scale (J, W large), and
is validated against this module in the kernel tests.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.configdict import ConfigDict
from repro_torch.core.job import Job

NEG = np.float64(np.inf)

# ---------------------------------------------------------------------------
# profile overlays (online re-characterization, docs/scenarios.md)
#
# A profile overlay is a per-consumer set of *belief* corrections over the
# offline profile: per-(engine, worker) multiplicative factors on the
# profiled qps.  Overlays never touch the ConfigDict entries themselves —
# the simulator's ground-truth execution times stay exactly the offline
# characterization — they only scale the [E, W] rows the schedulers score
# with.  Profile id 0 is the pristine profile (no overlay, no extra cache
# key component, bit-for-bit the historical tables); nonzero ids are
# allocated per ``OnlineRecharacterizer`` so two policies sharing one
# ConfigDict never see each other's refreshes.

_PROFILE_IDS = itertools.count(1)


def new_profile_id() -> int:
    """A process-unique nonzero profile id (one per overlay consumer)."""
    return next(_PROFILE_IDS)


class ProfileOverlay:
    """Mutable per-(engine, worker) qps scale factors for one profile id,
    plus the generation bookkeeping score caches invalidate against:
    ``gen`` bumps once per ``apply`` and ``touched[engine]`` records the
    generation that last refreshed each engine, so a cache can reclaim
    exactly the refreshed engines' rows and nothing else."""

    def __init__(self, cd: ConfigDict, pid: int):
        self.cd = cd
        self.pid = pid
        self.gen = 0
        self.scale: Dict[str, Dict[str, float]] = {}
        self.touched: Dict[str, int] = {}

    def factors(self, engine: str, workers: Sequence[str]) -> np.ndarray:
        """[W] qps scale vector for ``engine`` over ``workers``."""
        s = self.scale.get(engine)
        if not s:
            return np.ones(len(workers))
        return np.fromiter((s.get(w, 1.0) for w in workers),
                           dtype=np.float64, count=len(workers))

    def apply(self, updates: Dict[str, Dict[str, float]]) -> int:
        """One refresh: install new scale maps for ``updates``' engines,
        bump the generation, and write the refreshed rows through every
        already-built table of this profile (region slices read through
        their parent's arrays, so they update for free).  Returns the new
        generation."""
        if not updates:
            return self.gen
        self.gen += 1
        for engine, factors in updates.items():
            self.scale[engine] = dict(factors)
            self.touched[engine] = self.gen
        for tab in self.cd.__dict__.get("_row_cache", {}).values():
            if getattr(tab, "profile", 0) == self.pid:
                for engine in updates:
                    tab._refresh_engine(engine)
        return self.gen


def profile_overlay(cd: ConfigDict, pid: int) -> ProfileOverlay:
    """The overlay for ``pid`` on ``cd`` (created on first use)."""
    overlays = cd.__dict__.setdefault("_profile_overlays", {})
    ov = overlays.get(pid)
    if ov is None:
        ov = overlays[pid] = ProfileOverlay(cd, pid)
    return ov


def profile_gen(cd: ConfigDict, pid: int) -> int:
    """Generation counter of profile ``pid`` on ``cd`` — the score-cache
    invalidation token mirroring ``Cluster.fleet_gen``/``fail_gen``.
    Always 0 for the pristine profile (id 0) and for overlays that never
    refreshed, so pristine cache keys are unchanged."""
    if not pid:
        return 0
    ov = cd.__dict__.get("_profile_overlays", {}).get(pid)
    return ov.gen if ov is not None else 0


@dataclasses.dataclass
class ScoreResult:
    workers: List[str]
    t_estimated: np.ndarray        # [J, W]  (inf where infeasible)
    t_remaining: np.ndarray        # [J]
    acceptable: np.ndarray         # [J, W] bool (Eq. 3)
    best_worker: np.ndarray        # [J] int index into workers (Eq. 4; -1 none)
    urgency: np.ndarray            # [J]  (lower == more urgent)
    doomed: np.ndarray             # [J] bool — no acceptable worker

    @classmethod
    def empty(cls, workers: Sequence[str]) -> "ScoreResult":
        """The shaped zero-job result every scoring backend shares: all
        per-job axes are length 0, the worker axis keeps its width so
        downstream matrix consumers see consistent shapes."""
        z = np.zeros((0, len(workers)))
        return cls(list(workers), z, np.zeros(0), z.astype(bool),
                   np.zeros(0, np.int64), np.zeros(0),
                   np.zeros(0, bool))


class _EngineTable:
    """Stacked per-engine (qps, preproc) rows over a fixed worker list.

    The scheduler re-scores the whole queue every tick; at fleet scale that
    makes the [J, W] matrix build the hot path.  Engine rows are profiled
    once into a dense [E, W] table, and each call gathers job rows with a
    single C-speed fancy index instead of J x W ConfigDict lookups."""

    def __init__(self, cd: ConfigDict, workers: List[str],
                 use_default: bool, profile: int = 0):
        self.cd = cd
        self.workers = list(workers)
        self.use_default = use_default
        self.profile = profile
        self.index: Dict[str, int] = {}
        self.qps = np.empty((0, len(workers)))
        self.pre = np.empty((0, len(workers)))
        self.frac = np.empty((0, len(workers)))   # decode_frac (clamped)
        self.epq = np.empty((0, len(workers)))    # joules per query (c*)

    def _profiled_row(self, engine: str):
        from repro_torch.core.serving_bridge import decode_fraction
        W = len(self.workers)
        q = np.zeros(W)
        p = np.zeros(W)
        d = np.zeros(W)
        e = np.zeros(W)
        for wi, w in enumerate(self.workers):
            ent = (self.cd.default_entry(engine, w) if self.use_default
                   else self.cd.optimal(engine, w))
            if ent is not None and ent.qps > 0:
                q[wi] = ent.qps
                p[wi] = ent.preproc_s
                d[wi] = decode_fraction(ent)
                e[wi] = ent.energy_per_query_j
        if self.profile:
            # overlays are *throughput* beliefs; the profiled joules/query
            # stay the offline physics (mode power x query time)
            q *= profile_overlay(self.cd, self.profile).factors(
                engine, self.workers)
        return q, p, d, e

    def _add(self, engine: str):
        q, p, d, e = self._profiled_row(engine)
        self.index[engine] = len(self.qps)
        self.qps = np.vstack([self.qps, q[None]])
        self.pre = np.vstack([self.pre, p[None]])
        self.frac = np.vstack([self.frac, d[None]])
        self.epq = np.vstack([self.epq, e[None]])

    def _refresh_engine(self, engine: str):
        """Rebuild one engine's row in place from the ConfigDict and the
        current overlay factors (``ProfileOverlay.apply`` write-through;
        region slices read these arrays and see the update for free)."""
        i = self.index.get(engine)
        if i is None:
            return
        q, p, d, e = self._profiled_row(engine)
        self.qps[i] = q
        self.pre[i] = p
        self.frac[i] = d
        self.epq[i] = e

    def _rows(self, jobs: Sequence[Job]) -> np.ndarray:
        """[J] row indices into the [E, W] tables, profiling any engine
        on first sighting (shared by ``gather`` and the region-sliced
        views, which reuse these rows instead of re-profiling)."""
        idx = self.index
        try:
            return np.fromiter((idx[j.engine] for j in jobs),
                               dtype=np.intp, count=len(jobs))
        except KeyError:     # first sighting of an engine: profile it
            for job in jobs:
                if job.engine not in idx:
                    self._add(job.engine)
            return np.fromiter((idx[j.engine] for j in jobs),
                               dtype=np.intp, count=len(jobs))

    def gather(self, jobs: Sequence[Job]):
        rows = self._rows(jobs)
        return self.qps[rows], self.pre[rows], self.frac[rows]

    def gather_energy(self, jobs: Sequence[Job]) -> np.ndarray:
        """[J, W] joules/query at each worker's optimal configuration
        (0 marks infeasible pairs, matching ``qps == 0``)."""
        # bind rows first: a first-sighted engine rebinds self.epq
        rows = self._rows(jobs)
        return self.epq[rows]

    def row(self, engine: str):
        """One engine's (qps, preproc, decode_frac) rows over the worker
        list — the per-arrival gather used by SLO-MAEL's vectorized
        planner (profiles the engine on first sighting, like gather)."""
        i = self.index.get(engine)
        if i is None:
            self._add(engine)
            i = self.index[engine]
        return self.qps[i], self.pre[i], self.frac[i]

    def row_energy(self, engine: str) -> np.ndarray:
        """One engine's joules/query vector over the worker list."""
        i = self.index.get(engine)
        if i is None:
            self._add(engine)
            i = self.index[engine]
        return self.epq[i]


class _SlicedEngineTable:
    """A region's column slice of a parent ``_EngineTable``.

    Region-local scoring (``repro.core.hierarchy``) scores the same
    engines over a *subset* of the fleet's workers.  Every (engine,
    worker) cell of the parent table is profiled independently, so a
    column slice of the parent's [E, W] rows is bit-identical to a table
    profiled fresh over the region's worker list — this view shares the
    parent's rows (no re-profiling, no re-gathering) and slices with one
    fancy index per call.  Duck-typed to ``_EngineTable``'s read API."""

    def __init__(self, parent: _EngineTable, idx: np.ndarray):
        self.parent = parent
        self.idx = np.asarray(idx, dtype=np.intp)
        self.workers = [parent.workers[i] for i in self.idx]
        self.use_default = parent.use_default
        self.profile = parent.profile

    def _refresh_engine(self, engine: str):
        """No-op: slices hold no rows — they read the parent's arrays,
        which ``ProfileOverlay.apply`` already refreshed."""

    def gather(self, jobs: Sequence[Job]):
        p = self.parent
        rows = p._rows(jobs)[:, None]
        cols = self.idx
        return p.qps[rows, cols], p.pre[rows, cols], p.frac[rows, cols]

    def gather_energy(self, jobs: Sequence[Job]) -> np.ndarray:
        p = self.parent
        rows = p._rows(jobs)        # may rebind p.epq (first sighting)
        return p.epq[rows[:, None], self.idx]

    def row(self, engine: str):
        q, p, d = self.parent.row(engine)
        return q[self.idx], p[self.idx], d[self.idx]

    def row_energy(self, engine: str) -> np.ndarray:
        return self.parent.row_energy(engine)[self.idx]


# Interned worker tuples: the row cache below used to be keyed by
# ``(use_default, tuple(workers))`` — hashing a hundreds-of-strings tuple
# on every scheduler tick.  Interning maps each distinct worker tuple to a
# small int once, scoped to the ConfigDict (so the table dies with it);
# per-tick callers (``Cluster.worker_token``) hold the int and skip the
# tuple hash entirely, while one-shot callers still land on the same
# cache entry through a single interning lookup.


def intern_worker_tuple(cd: ConfigDict, workers) -> int:
    """The generation id of a worker list on ``cd``: equal lists → equal
    token (tokens from different ConfigDicts are unrelated — every cache
    keyed by them lives on the same ConfigDict)."""
    tokens = cd.__dict__.setdefault("_worker_tokens", {})
    t = tuple(workers)
    tok = tokens.get(t)
    if tok is None:
        tok = tokens[t] = len(tokens)
    return tok


def _table(cd: ConfigDict, workers: List[str], use_default: bool,
           token: Optional[int] = None, profile: int = 0) -> _EngineTable:
    """The per-(use_default, worker-tuple[, profile]) ``_EngineTable``,
    cached on the ConfigDict (one cache shared by every matrix builder
    below).  ``token`` is the pre-interned worker-tuple id
    (``intern_worker_tuple``); passing it skips re-hashing the tuple on
    the per-tick hot path.  ``profile`` selects a ``ProfileOverlay``'s
    belief-scaled tables; 0 (pristine) keeps the historical 2-tuple key,
    so pre-overlay cache entries are untouched."""
    cache = cd.__dict__.setdefault("_row_cache", {})
    tok = intern_worker_tuple(cd, workers) if token is None else token
    key = (use_default, tok) if not profile else (use_default, tok, profile)
    tab = cache.get(key)
    if tab is None:
        tab = cache[key] = _EngineTable(cd, workers, use_default, profile)
    return tab


def register_region_table(cd: ConfigDict, workers: Sequence[str],
                          region_idx, use_default: bool = False,
                          token: Optional[int] = None,
                          profile: int = 0) -> int:
    """Install a region's column-sliced view of the full-fleet row table
    under the region worker tuple's interned token, and return that
    token.  After this, every matrix builder above called with the
    region's worker list (or its token) lands on the shared slice —
    region-local scoring never re-profiles or re-gathers what the flat
    table already holds.  Safe to share the cache slot with flat callers:
    the sliced values agree bit-for-bit with a fresh region table."""
    parent = _table(cd, list(workers), use_default, token, profile)
    idx = np.asarray(region_idx, dtype=np.intp)
    rtok = intern_worker_tuple(cd, [workers[i] for i in idx])
    cache = cd.__dict__.setdefault("_row_cache", {})
    key = ((use_default, rtok) if not profile
           else (use_default, rtok, profile))
    if key not in cache:
        cache[key] = _SlicedEngineTable(parent, idx)
    return rtok


def engine_rows(cd: ConfigDict, engine: str, workers: List[str],
                use_default: bool = False, token: Optional[int] = None,
                profile: int = 0):
    """One engine's (qps, preproc, decode_frac) vectors over ``workers``
    (``qps == 0`` marks infeasible pools), from the shared row cache."""
    return _table(cd, workers, use_default, token, profile).row(engine)


def score_matrices(cd: ConfigDict, jobs: Sequence[Job], workers: List[str],
                   use_default: bool = False, token: Optional[int] = None,
                   profile: int = 0):
    """[J, W] qps / preproc matrices from the Configuration Dictionary
    (``qps == 0`` marks infeasible pairs), cached per worker tuple on the
    ConfigDict.  Shared input builder for the numpy scorer below and the
    Pallas kernel path (``repro.core.pallas_scoring``)."""
    return _table(cd, workers, use_default, token, profile).gather(jobs)[:2]


def phase_split_matrices(cd: ConfigDict, jobs: Sequence[Job],
                         workers: List[str], use_default: bool = False,
                         token: Optional[int] = None, profile: int = 0):
    """[J, W] (prefill_s, decode_s) solo-service matrices (inf where
    infeasible): the prefill prefix ``pre + (q/qps) * (1 - decode_frac)``
    — a worker's TTFT contribution — and the per-token decode remainder
    ``(q/qps) * decode_frac``.  Their sum is Eq. 2's ``t_estimated``; the
    split is what streaming-QoS gating and phase-aware placement under
    disaggregated pools score against (shares the per-worker-tuple row
    cache with ``score_matrices``)."""
    qps, pre, frac = _table(cd, workers, use_default, token,
                            profile).gather(jobs)
    q = np.fromiter((float(j.queries) for j in jobs), dtype=np.float64,
                    count=len(jobs))
    with np.errstate(divide="ignore", invalid="ignore"):
        exec_q = q[:, None] / qps
        prefill = np.where(qps > 0, pre + exec_q * (1.0 - frac), np.inf)
        decode = np.where(qps > 0, exec_q * frac, np.inf)
    return prefill, decode


def energy_matrix(cd: ConfigDict, jobs: Sequence[Job], workers: List[str],
                  use_default: bool = False, token: Optional[int] = None,
                  profile: int = 0) -> np.ndarray:
    """[J, W] estimated whole-job joules: ``queries x joules/query`` at
    each worker's profiled optimal configuration, ``inf`` where the pair
    is infeasible (mirroring Eq. 2's inf cells, so the energy term never
    resurrects an infeasible placement).  This is the row source behind
    ``SynergAI(energy_weight=...)``'s weighted energy/carbon term; shares
    the per-worker-tuple row cache with ``score_matrices``."""
    epq = _table(cd, workers, use_default, token, profile).gather_energy(jobs)
    q = np.fromiter((float(j.queries) for j in jobs), dtype=np.float64,
                    count=len(jobs))
    return np.where(epq > 0, q[:, None] * epq, np.inf)


def estimate_matrix(cd: ConfigDict, jobs: Sequence[Job], workers: List[str],
                    now: float, use_default: bool = False,
                    token: Optional[int] = None,
                    profile: int = 0) -> ScoreResult:
    """Vectorized Eq. 1-4 over all queued jobs and all workers."""
    J = len(jobs)
    if not J:
        return ScoreResult.empty(workers)
    qps, pre = score_matrices(cd, jobs, workers, use_default, token,
                              profile)
    q = np.fromiter((float(j.queries) for j in jobs), dtype=np.float64,
                    count=J)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_est = np.where(qps > 0, pre + q[:, None] / qps, np.inf)  # Eq. 2
    t_rem = np.fromiter((j.t_qos - (now - j.arrival) for j in jobs),
                        dtype=np.float64, count=J)                 # Eq. 1
    acceptable = t_rem[:, None] >= t_est                           # Eq. 3
    # Eq. 4: argmin over acceptable workers; fall back to global argmin of
    # feasible workers when nothing is acceptable (doomed jobs still run).
    masked = np.where(acceptable, t_est, np.inf)
    min_est = t_est.min(axis=1)     # inf where nothing is feasible
    best = np.where(np.isfinite(masked.min(axis=1)), masked.argmin(1),
                    np.where(np.isfinite(min_est), t_est.argmin(1), -1))
    urgency = t_rem - min_est       # -> 0 means about to violate
    doomed = ~acceptable.any(axis=1)
    return ScoreResult(workers, t_est, t_rem, acceptable,
                       best.astype(np.int64), urgency, doomed)


# score_fn protocol markers: SynergAI forwards the cluster's interned
# worker token — and, when a recharacterizer is attached, the profile
# overlay id — to backends that advertise support for them
estimate_matrix.takes_token = True
estimate_matrix.takes_profile = True


def candidate_order(score: ScoreResult, ji: int,
                    busy_wait: Optional[np.ndarray] = None) -> List[int]:
    """Per-job worker candidates (paper: the sorted (w, c*) list).

    Non-doomed jobs only consider their *acceptable* set — if none of those
    workers are free the job waits rather than burning its QoS budget on a
    worker that cannot meet it.  Doomed jobs (nothing acceptable) minimize
    expected *completion*: candidates are ordered by (current busy wait +
    T_estimated) so a doomed job waits for a fast worker instead of seizing
    a far slower idle one and blocking it for everyone else.
    """
    t = score.t_estimated[ji]
    if score.doomed[ji]:
        cost = t + (busy_wait if busy_wait is not None else 0.0)
        order = np.argsort(cost, kind="stable")
        return [int(w) for w in order if np.isfinite(t[w])]
    order = np.argsort(t, kind="stable")
    feasible = [int(w) for w in order if np.isfinite(t[w])]
    return [w for w in feasible if score.acceptable[ji, w]]
