# Port of repro/core/scorecache.py: the same numpy code, imports rewritten to repro_torch.
"""Persistent cross-tick score cache for the scheduling hot path
(docs/performance.md).

``SynergAI`` re-scores the whole queue on every simulator tick, but the
quantities behind Eq. 2 are *time-invariant per (job, worker-set)*:
``t_estimated[j, w] = preproc + queries / qps`` never changes while a job
waits.  Only Eq. 1's remaining budget — and everything derived from it
(acceptability, urgency, doom) — decays with the clock.  At fleet scale
(10k queued jobs x 64 pools) rebuilding the full ``[J, W]`` matrix each
tick dominates the per-decision cost, which is exactly the sublinearity
argument PerLLM (arXiv:2405.14636) makes for edge-cloud schedulers.

``ScoreCache`` therefore persists the estimate rows across ticks, keyed
by job id, in a slot pool that survives queue churn:

* **arrivals** append rows (one batched ``score_matrices`` gather per
  tick covers every new job);
* **placements / finishes** just leave their slot behind; slots are
  reclaimed lazily, so a failure-requeued job or a disaggregated decode
  leg that re-enters the queue finds its row still warm;
* **elastic provisioning** (clone pools appended to the fleet) extends
  the cached rows by the new columns only;
* **fleet-generation changes** — failures (``Cluster.fail_gen``) or any
  non-append membership change — flush the cache outright.  Failure
  state never enters these rows, so the flush is pure conservatism: the
  invalidation rule stays one comparison instead of a proof.

Alongside the ``[W]`` rows the cache pins each job's static scalars
(``t_qos``, ``arrival``, ``min_w t_estimated``, streaming deadlines,
decoded-token counts), so a plain tick recomputes the time-decaying
quantities with O(J) vector ops and never touches the matrix at all.
The row values are produced by the exact expressions of
``estimator.estimate_matrix`` / ``phase_split_matrices``, which is what
keeps cached and uncached schedules bit-for-bit identical
(``tests/test_scorecache.py``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engines import engine_catalogue
from repro_torch.core.estimator import (energy_matrix, phase_split_matrices,
                                  profile_gen, profile_overlay,
                                  score_matrices)

_GROW = 256          # minimum slot-pool growth (amortized doubling)


class ScoreCache:
    def __init__(self, use_default: bool = False, profile: int = 0):
        self.use_default = use_default
        # profile overlay id (online re-characterization): rows are built
        # from that profile's belief-scaled tables, and the overlay's
        # generation joins the cache key below.  0 (pristine) keeps the
        # generation pinned at 0 — historical behavior, bit-for-bit.
        self.profile = profile
        # cache identity: (cluster serial, interned worker tuple, failure
        # generation, profile generation) — any mismatch is an
        # invalidation event
        self._key = None
        self._names: tuple = ()
        self._W = 0
        self._slot: Dict[int, int] = {}     # job id -> row slot
        self._free: List[int] = []          # recycled slots
        self._next = 0                      # high-water mark of the pool
        self._cap = 0
        self._have_phase = False            # pre/dec rows materialized
        self._have_energy = False           # energy rows materialized
        self._alloc(0, 0)
        # introspection (tests, docs, bench)
        self.flushes = 0
        self.col_extends = 0
        self.rows_computed = 0
        self.profile_reclaims = 0           # slots dropped by a refresh
        self.releases = 0                   # slots freed on terminal exit

    # ------------------------------------------------------------------
    # storage

    def _alloc(self, cap: int, W: int):
        self._cap = cap
        self._t = np.empty((cap, W))        # Eq. 2 full-service rows
        self._min = np.empty(cap)           # min_w of each row
        self._amin = np.empty(cap, np.intp)  # a column attaining that min
        self._pre = np.empty((cap, W)) if self._have_phase else None
        self._dec = np.empty((cap, W)) if self._have_phase else None
        self._ene = np.empty((cap, W)) if self._have_energy else None
        self._qos = np.empty(cap)           # static job scalars
        self._arr = np.empty(cap)
        self._ttft_qos = np.empty(cap)
        self._tpot_qos = np.empty(cap)
        self._dtok = np.empty(cap)
        self._has_ttft = np.empty(cap, bool)
        self._has_tpot = np.empty(cap, bool)
        self._eng: List[Optional[str]] = [None] * cap  # slot -> engine

    def _flush(self, W: int):
        if self._slot:
            self.flushes += 1
        self._slot = {}
        self._free = []
        self._next = 0
        self._have_phase = False
        self._have_energy = False
        self._W = W
        self._alloc(0, W)

    def _grow(self, need: int):
        new_cap = max(self._cap * 2, self._cap + need, _GROW)
        old = self._cap

        def wider(a, shape):
            b = np.empty(shape, a.dtype)
            b[:old] = a
            return b

        self._cap = new_cap
        self._t = wider(self._t, (new_cap, self._W))
        self._min = wider(self._min, new_cap)
        self._amin = wider(self._amin, new_cap)
        if self._have_phase:
            self._pre = wider(self._pre, (new_cap, self._W))
            self._dec = wider(self._dec, (new_cap, self._W))
        if self._have_energy:
            self._ene = wider(self._ene, (new_cap, self._W))
        self._qos = wider(self._qos, new_cap)
        self._arr = wider(self._arr, new_cap)
        self._ttft_qos = wider(self._ttft_qos, new_cap)
        self._tpot_qos = wider(self._tpot_qos, new_cap)
        self._dtok = wider(self._dtok, new_cap)
        self._has_ttft = wider(self._has_ttft, new_cap)
        self._has_tpot = wider(self._has_tpot, new_cap)
        self._eng = self._eng + [None] * (new_cap - old)

    def _reclaim(self, queue):
        """Drop slots whose jobs left the queue (placed / finished)."""
        keep = {j.id for j in queue}
        gone = [jid for jid in self._slot if jid not in keep]
        for jid in gone:
            self._free.append(self._slot.pop(jid))

    def release(self, jid: int) -> bool:
        """Reclaim-on-shed invalidation rule: a job that reached a
        *terminal* outcome without completing (shed / abandoned / failed
        out of its retry budget) never returns to the queue, so its row
        is freed eagerly instead of waiting for the lazy ``_reclaim``
        surplus trigger.  Keeping a dead row warm is harmless for
        correctness but under sustained shedding the surplus would churn
        the slot pool; this keeps the live-row set tracking the queue.
        Returns True when a slot was actually freed."""
        s = self._slot.pop(jid, None)
        if s is None:
            return False
        self._free.append(s)
        self.releases += 1
        return True

    def _reclaim_profile(self, cd, seen_gen: int):
        """Selective profile invalidation: drop exactly the slots whose
        engine was refreshed after ``seen_gen`` (the overlay generation
        this cache last synced at).  Every other row is untouched — the
        minimal-flush rule ``tests/test_recharacterize.py`` pins."""
        touched = profile_overlay(cd, self.profile).touched
        gone = [jid for jid, s in self._slot.items()
                if touched.get(self._eng[s], 0) > seen_gen]
        for jid in gone:
            self._free.append(self._slot.pop(jid))
        self.profile_reclaims += len(gone)

    # ------------------------------------------------------------------
    # synchronization

    def sync(self, cd, queue, cluster) -> np.ndarray:
        """Reconcile the cache with this tick's queue; returns the [J]
        slot indices of ``queue`` (in order) into the row pool."""
        names = cluster.arrays.names
        key = (cluster.serial, cluster.worker_token, cluster.fail_gen,
               profile_gen(cd, self.profile))
        if key != self._key:
            old = self._key
            if old is not None and old[:3] == key[:3]:
                # same cluster, same workers, no failures: only the
                # profile generation moved — an online re-profile.  The
                # overlay's touched log names exactly the refreshed
                # engines; drop only their slots (the rows of every other
                # engine still match the tables bit-for-bit).
                self._reclaim_profile(cd, old[3])
            elif (old is not None and old[0] == key[0] and old[2] == key[2]
                    and old[3] == key[3]
                    and len(names) > len(self._names)
                    and tuple(names[:len(self._names)]) == self._names):
                # same cluster, no failures, same profile, workers
                # appended at the end: elastic provisioning — extend the
                # columns in place
                self._extend_columns(cd, queue, cluster, names)
            else:
                self._flush(len(names))
            self._key = key
            self._names = tuple(names)
        J = len(queue)
        slot = self._slot
        slots = np.fromiter((slot.get(j.id, -1) for j in queue),
                            dtype=np.intp, count=J)
        miss = np.nonzero(slots < 0)[0]
        if miss.size:
            self._insert([queue[i] for i in miss], cd, cluster, slots, miss)
        # lazy slot reclamation: departed rows are left warm (a requeued
        # job reuses its row) until they outnumber the live queue
        if len(slot) - J > max(_GROW, J):
            self._reclaim(queue)
        return slots

    def _row_values(self, jobs, cd, cluster):
        """The exact ``estimate_matrix`` expressions for a batch of jobs:
        [n, W] full-service times (inf where infeasible) + row minima."""
        qps, pre = score_matrices(cd, jobs, list(self._names),
                                  self.use_default,
                                  token=cluster.worker_token,
                                  profile=self.profile)
        q = np.fromiter((float(j.queries) for j in jobs),
                        dtype=np.float64, count=len(jobs))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(qps > 0, pre + q[:, None] / qps, np.inf)
        return t

    def _insert(self, jobs, cd, cluster, slots, miss):
        n = len(jobs)
        self.rows_computed += n
        dest = np.empty(n, dtype=np.intp)
        free = self._free
        for k in range(n):
            if free:
                dest[k] = free.pop()
            else:
                if self._next >= self._cap:
                    self._grow(n - k)
                dest[k] = self._next
                self._next += 1
        t = self._row_values(jobs, cd, cluster)
        self._t[dest] = t
        self._min[dest] = t.min(axis=1)
        self._amin[dest] = t.argmin(axis=1) if t.shape[1] else 0
        if self._have_phase:
            pre_m, dec_m = phase_split_matrices(
                cd, jobs, list(self._names), self.use_default,
                token=cluster.worker_token, profile=self.profile)
            self._pre[dest] = pre_m
            self._dec[dest] = dec_m
        if self._have_energy:
            self._ene[dest] = energy_matrix(
                cd, jobs, list(self._names), self.use_default,
                token=cluster.worker_token, profile=self.profile)
        engines = engine_catalogue()
        for k, (s, j) in enumerate(zip(dest, jobs)):
            r = j.request
            self._eng[s] = j.engine
            self._qos[s] = j.t_qos
            self._arr[s] = j.arrival
            has_ttft = r is not None and r.ttft_qos is not None
            has_tpot = r is not None and r.tpot_qos is not None
            self._has_ttft[s] = has_ttft
            self._has_tpot[s] = has_tpot
            self._ttft_qos[s] = r.ttft_qos if has_ttft else np.inf
            self._tpot_qos[s] = r.tpot_qos if has_tpot else np.inf
            self._dtok[s] = (
                float(j.queries * engines[j.engine].decode_len)
                if j.engine in engines
                else (float(r.decode_tokens)
                      if r is not None and r.decode_tokens > 0 else np.inf))
            self._slot[j.id] = s
            slots[miss[k]] = s

    def _extend_columns(self, cd, queue, cluster, names):
        """Elastic provisioning appended pools: widen every live row by
        the new columns (recomputing only those), keep everything else."""
        self.col_extends += 1
        old_W = self._W
        new_names = list(names[old_W:])
        W = len(names)
        # rows for jobs no longer queued can't be extended (their Job
        # objects are gone) — reclaim them first
        self._reclaim(queue)

        def widen(a, fill=np.inf):
            b = np.full((self._cap, W), fill)
            b[:, :old_W] = a
            return b

        self._t = widen(self._t)
        if self._have_phase:
            self._pre = widen(self._pre)
            self._dec = widen(self._dec)
        if self._have_energy:
            self._ene = widen(self._ene)
        self._W = W
        live = [(self._slot[j.id], j) for j in queue
                if j.id in self._slot]
        if live:
            sl = np.array([s for s, _ in live], dtype=np.intp)
            jobs = [j for _, j in live]
            qps, pre = score_matrices(cd, jobs, new_names,
                                      self.use_default,
                                      profile=self.profile)
            q = np.fromiter((float(j.queries) for j in jobs),
                            dtype=np.float64, count=len(jobs))
            with np.errstate(divide="ignore", invalid="ignore"):
                t_new = np.where(qps > 0, pre + q[:, None] / qps, np.inf)
            self._t[sl, old_W:] = t_new
            # min over (old row, new columns) == min over the full row;
            # the argmin hint moves only on a strict improvement (ties
            # keep the old column — any minimizing index is valid)
            new_min = t_new.min(axis=1)
            better = new_min < self._min[sl]
            self._amin[sl] = np.where(
                better, old_W + t_new.argmin(axis=1), self._amin[sl])
            self._min[sl] = np.minimum(self._min[sl], new_min)
            if self._have_phase:
                pre_m, dec_m = phase_split_matrices(cd, jobs, new_names,
                                                    self.use_default,
                                                    profile=self.profile)
                self._pre[sl, old_W:] = pre_m
                self._dec[sl, old_W:] = dec_m
            if self._have_energy:
                self._ene[sl, old_W:] = energy_matrix(
                    cd, jobs, new_names, self.use_default,
                    profile=self.profile)

    def ensure_phase_rows(self, cd, queue, slots, cluster):
        """Materialize the prefill/decode split rows (streaming QoS /
        disaggregated scoring) for every live job; later inserts keep
        them up to date.  No-op once enabled."""
        if self._have_phase:
            return
        # stale (departed) slots can't be backfilled — drop them so a
        # requeued job recomputes all three rows together
        self._reclaim(queue)
        self._have_phase = True
        self._pre = np.full((self._cap, self._W), np.inf)
        self._dec = np.full((self._cap, self._W), np.inf)
        if len(queue):
            pre_m, dec_m = phase_split_matrices(
                cd, queue, list(self._names), self.use_default,
                token=cluster.worker_token, profile=self.profile)
            self._pre[slots] = pre_m
            self._dec[slots] = dec_m

    def ensure_energy_rows(self, cd, queue, slots, cluster):
        """Materialize the estimated whole-job energy rows
        (``estimator.energy_matrix``: queries x joules/query, inf where
        infeasible) for every live job — the row source behind
        ``SynergAI(energy_weight=...)``.  Lazy exactly like the phase
        rows: never touched at weight 0, kept up to date by later
        inserts/column extensions, flushed with everything else, and
        subject to the same invalidation rules.  No-op once enabled."""
        if self._have_energy:
            return
        # stale (departed) slots can't be backfilled — drop them so a
        # requeued job recomputes all rows together
        self._reclaim(queue)
        self._have_energy = True
        self._ene = np.full((self._cap, self._W), np.inf)
        if len(queue):
            self._ene[slots] = energy_matrix(
                cd, queue, list(self._names), self.use_default,
                token=cluster.worker_token, profile=self.profile)

    # ------------------------------------------------------------------
    # views (all take the slot vector returned by ``sync``)

    def t_remaining(self, slots, now: float) -> np.ndarray:
        """Eq. 1 for the whole queue, from the cached static scalars."""
        return self._qos[slots] - (now - self._arr[slots])

    def min_estimate(self, slots) -> np.ndarray:
        return self._min[slots]

    def argmin_estimate(self, slots) -> np.ndarray:
        """A column attaining each row's minimum — the fast-path hint
        behind incremental depth-penalty doom: a job whose cheapest
        worker carries no penalty is certainly not doomed, so only jobs
        whose argmin column sits on a live batch gather their row."""
        return self._amin[slots]

    def row(self, s: int) -> np.ndarray:
        """One job's cached [W] estimate row (a view, not a copy)."""
        return self._t[s]

    def t_matrix(self, slots) -> np.ndarray:
        return self._t[slots]

    def phase_matrices(self, slots):
        return self._pre[slots], self._dec[slots]

    def energy_matrix(self, slots) -> np.ndarray:
        return self._ene[slots]

    def energy_row(self, s: int) -> np.ndarray:
        """One job's cached [W] estimated-joules row (a view)."""
        return self._ene[s]

    def waiting(self, slots, now: float) -> np.ndarray:
        return now - self._arr[slots]

    def has_ttft(self, slots) -> np.ndarray:
        return self._has_ttft[slots]

    def has_tpot(self, slots) -> np.ndarray:
        return self._has_tpot[slots]

    def ttft_qos(self, slots) -> np.ndarray:
        return self._ttft_qos[slots]

    def tpot_qos(self, slots) -> np.ndarray:
        return self._tpot_qos[slots]

    def dtok(self, slots) -> np.ndarray:
        return self._dtok[slots]
