# Port of repro/core/recharacterize.py: the same numpy code, imports rewritten to repro_torch.
"""Online re-characterization — the paper's offline/online loop, closed.

SynergAI's §4 characterization is an *offline* step: per-(engine, worker)
profiles are measured once and the Eq. 1-4 estimator trusts them for the
whole run.  The runtime scheduler is adaptive — every tick re-scores the
queue against live worker state — but the *profiles themselves* are
frozen, so when the world drifts away from them (an edge pool thermally
throttles, a colocated tenant steals cycles, a model update changes an
engine's throughput) every estimate on the drifted rows is silently
wrong: a throttled pool still *looks* fast, keeps winning Eq. 4's
argmin, and QoS violations pile up on it.

``OnlineRecharacterizer`` closes the loop without touching the offline
profiles (they stay the simulator's ground-truth physics).  It maintains
a per-policy *belief overlay* (``estimator.ProfileOverlay``):
multiplicative effective-rate scale factors per (engine, worker) that
the policy's estimator tables and score cache read through a
process-unique ``profile`` id.

**Detection** — two windowed signals, each anchored per regime:

- **Arrival-mix drift** — per-region engine shares over a fixed-size
  window, compared by total-variation distance against the *first*
  window of the current regime (a fixed anchor: smooth drift accumulates
  against it instead of being chased by a moving average).  ``confirm``
  consecutive over-threshold windows trigger.
- **Service residuals** — log(observed solo service / profile
  prediction) per completion.  The observable is ``JobResult.service_s
  / service_pred_s`` — the simulator records both the slowdown+noise
  solo service seconds and the profile model's own prediction for them,
  so the ratio is exactly ``slowdown * exec noise``, free of batch
  contention, transfer time and service-model approximation error.
  The prediction is read through the *current beliefs* (divided by the
  overlay's scale for that cell), so a corrected drift returns the
  residual to zero.  Each window compares the global mean and every
  well-sampled worker's and engine's mean-relative margin against the
  regime's first window; a per-worker rolling deque additionally fires
  as soon as any single pool accumulates ``min_count`` deviating
  samples, without waiting for the global window.  All bars scale with
  the anchor window's noise level (``z * s0 / sqrt(n)``).

**Refresh** — the cheap online re-profile: re-fit per-engine effective
service rates from the last-N completed ``JobResult``s.  The recent
residuals decompose hierarchically (sparse (engine, worker) cells
borrow strength from their margins)::

    log f_{e,w} = m + (mean_e - m) + (mean_w - m)

every effect measured relative to the anchor and installed only when it
clears the same z-significance bar the detector uses — a trigger with
no real physics deviation (an arrival-mix shift, say) refits to *zero
updates* and the schedule stays bit-for-bit unchanged.  Corrections
*compose* multiplicatively onto the already-installed scales
(``scale_{e,w} *= clamp(exp(-log f_{e,w}))``): residuals are
belief-relative, so a fully corrected drift goes quiet by itself while
an under-corrected one keeps deviating, re-fires, and converges on the
true factor.  A pool observed 3x slower than its profile is *believed*
3x slower, so Eq. 2's estimates match reality again and placement
routes around it.

``ProfileOverlay.apply`` bumps the overlay generation;
``ScoreCache.sync`` sees the ``profile_gen`` component of its key move
and reclaims exactly the refreshed engines' cached rows
(``_reclaim_profile``), so cached == uncached stays bit-for-bit through
any interleaving of refreshes, failures and elastic clones.

One instance may be shared by a whole policy tree
(``HierarchicalSynergAI`` passes itself to every per-region core): all
consumers read the same profile id, each region feeds its own mix
window, any region's trigger refreshes the shared overlay once.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.engines import engine_catalogue
from repro_torch.core.estimator import engine_rows, new_profile_id, profile_overlay


class _MixWindow:
    """One region's anchored arrival-mix drift test.

    Engine shares over ``window`` arrivals, total-variation distance
    against the regime's first window.  ``add`` returns True when
    ``confirm`` consecutive windows exceed ``threshold``."""

    def __init__(self, window: int, threshold: float, confirm: int):
        self.window = window
        self.threshold = threshold
        self.confirm = confirm
        self.counts: Dict[str, int] = {}
        self.n = 0
        self.anchor: Optional[Dict[str, float]] = None
        self.streak = 0
        self.last_tv = 0.0

    def add(self, engine: str) -> bool:
        self.counts[engine] = self.counts.get(engine, 0) + 1
        self.n += 1
        if self.n < self.window:
            return False
        shares = {e: c / self.n for e, c in self.counts.items()}
        self.counts = {}
        self.n = 0
        if self.anchor is None:
            self.anchor = shares
            return False
        keys = set(shares) | set(self.anchor)
        self.last_tv = 0.5 * sum(
            abs(shares.get(e, 0.0) - self.anchor.get(e, 0.0)) for e in keys)
        self.streak = self.streak + 1 if self.last_tv > self.threshold else 0
        return self.streak >= self.confirm

    def reset(self):
        """New regime (post-refresh): the next window re-anchors."""
        self.anchor = None
        self.streak = 0
        self.counts = {}
        self.n = 0


class _ResidWindow:
    """Anchored service-residual drift test over completions.

    Every ``window`` completions: the global mean log-residual plus
    each worker's and engine's margin *relative to the contemporaneous
    global mean* are compared against the regime's first window
    (relative margins cancel any bias common to the whole fleet).  The
    per-worker terms catch a localized degradation (one throttled pool)
    that the global mean would dilute.  A worker with only a few
    samples still counts — its bar scales with the anchor window's
    noise level (``z * s0 / sqrt(n)``), so a genuine 3x slowdown trips
    on a handful of completions while stationary noise stays ~z sigma
    below (z is deliberately high: the rolling test re-runs at every
    completion across the whole fleet, and the bar has to survive that
    many comparisons without a false fire)."""

    def __init__(self, window: int, threshold: float, min_count: int = 4,
                 z: float = 8.0, k_roll: int = 8):
        self.window = window
        self.threshold = threshold
        self.min_count = min_count
        self.z = z
        self.k_roll = k_roll
        # batched serving stretches every residual by the load-dependent
        # batch multiplier, so the *absolute* global-mean test is
        # confounded there and only runs in job mode; the per-worker and
        # per-engine tests compare margins *relative to the
        # contemporaneous global mean*, which cancels any bias common to
        # the whole fleet (load swings, batching) in both modes
        self.use_global = True
        self.buf: List[Tuple[str, str, float]] = []   # (engine, worker, lr)
        # anchor: (global mean m0, per-worker mean_w - m0,
        #          per-engine mean_e - m0, residual noise std)
        self.anchor: Optional[Tuple[float, Dict[str, float],
                                    Dict[str, float], float]] = None
        # the last completed window's raw samples — when a window fires,
        # these ARE the post-drift evidence, so the refresh re-fits from
        # them instead of a recency deque polluted by pre-drift history
        self.last_buf: Optional[List[Tuple[str, str, float]]] = None
        # per-worker rolling evidence, spanning window boundaries: a
        # badly degraded pool completes so few jobs it may never reach
        # min_count inside one global window — its own last ``k_roll``
        # samples still accumulate and trigger.  Cleared on every
        # refresh so the evidence is epoch-pure (post-correction only).
        self.wdq: Dict[str, Deque[float]] = {}
        # contemporaneous global mean for the rolling check
        self.gdq: Deque[float] = deque(maxlen=4 * k_roll)
        self.last_dev = 0.0

    def add(self, engine: str, worker: str, logresid: float) -> bool:
        self.buf.append((engine, worker, logresid))
        self.gdq.append(logresid)
        dq = self.wdq.get(worker)
        if dq is None:
            dq = self.wdq[worker] = deque(maxlen=self.k_roll)
        dq.append(logresid)
        if (self.anchor is not None and len(dq) >= self.min_count
                and len(self.gdq) >= 2 * self.k_roll):
            _m0, wrel0, _erel0, s0 = self.anchor
            m_roll = sum(self.gdq) / len(self.gdq)
            dev = abs((sum(dq) / len(dq) - m_roll)
                      - wrel0.get(worker, 0.0))
            if dev > max(self.threshold,
                         self.z * s0 / math.sqrt(len(dq))):
                self.last_dev = dev
                return True
        if len(self.buf) < self.window:
            return False
        wsum: Dict[str, float] = {}
        wcnt: Dict[str, int] = {}
        esum: Dict[str, float] = {}
        ecnt: Dict[str, int] = {}
        total = sq = 0.0
        for e, w, lr in self.buf:
            wsum[w] = wsum.get(w, 0.0) + lr
            wcnt[w] = wcnt.get(w, 0) + 1
            esum[e] = esum.get(e, 0.0) + lr
            ecnt[e] = ecnt.get(e, 0) + 1
            total += lr
            sq += lr * lr
        n = len(self.buf)
        m = total / n
        self.last_buf = self.buf
        self.buf = []
        if self.anchor is None:
            s0 = max(0.05, math.sqrt(max(0.0, sq / n - m * m)))
            self.anchor = (m,
                           {w: wsum[w] / wcnt[w] - m for w in wsum},
                           {e: esum[e] / ecnt[e] - m for e in esum},
                           s0)
            return False
        m0, wrel0, erel0, s0 = self.anchor
        fired = self.use_global and abs(m - m0) > self.threshold
        self.last_dev = abs(m - m0) if self.use_global else 0.0
        for margin, rel0 in (((wsum, wcnt), wrel0), ((esum, ecnt), erel0)):
            sums, counts = margin
            for k, c in counts.items():
                if c < self.min_count:
                    continue
                dev = abs((sums[k] / c - m) - rel0.get(k, 0.0))
                bar = max(self.threshold, self.z * s0 / math.sqrt(c))
                self.last_dev = max(self.last_dev, dev)
                if dev > bar:
                    fired = True
        return fired

    def worker_evidence(self) -> Dict[str, Tuple[float, int]]:
        """(mean, count) of each worker's rolling post-refresh samples —
        the refresh's fallback margin for pools too slow to reach
        ``min_count`` inside the firing window."""
        return {w: (sum(dq) / len(dq), len(dq))
                for w, dq in self.wdq.items() if dq}

    def epoch_reset(self):
        """Called after a successful refresh: the beliefs just moved, so
        every buffered belief-relative sample is from the old epoch.
        The anchor survives — residuals of a *corrected* regime return
        to it by construction."""
        self.buf = []
        self.wdq.clear()
        self.gdq.clear()

    def reset(self):
        self.anchor = None
        self.buf = []
        self.last_buf = None
        self.wdq.clear()
        self.gdq.clear()


class OnlineRecharacterizer:
    """Drift detection + estimator refresh for one policy (tree).

    Pass the same instance to ``SynergAI``, ``SloMael`` or
    ``HierarchicalSynergAI``; the policy calls ``observe_arrival`` /
    ``observe_complete`` from its simulator hooks and everything else is
    automatic.  ``seed`` is the oracle entry point for tests/benches: it
    installs the refresh computed from the *true* drift factors,
    skipping detection and re-fit latency entirely.

    Introspection: ``refreshes`` (count), ``triggered_at`` (sim times),
    ``last_reason`` (``"mix:<region>"``, ``"residual"`` or ``"seed"``),
    ``profile`` (the overlay id consumers score through).
    """

    def __init__(self, window: int = 128, threshold: float = 0.3,
                 confirm: int = 2, resid_threshold: float = 0.35,
                 resid_clamp: float = 8.0, detect: bool = True):
        self.window = int(window)
        self.threshold = float(threshold)
        self.confirm = int(confirm)
        self.resid_threshold = float(resid_threshold)
        self.resid_clamp = float(resid_clamp)
        self.detect = bool(detect)
        self.profile = new_profile_id()
        self._min_count = 4
        self._mix: Dict[str, _MixWindow] = {}
        self._resid = _ResidWindow(self.window, self.resid_threshold,
                                   self._min_count)
        self._widx: Optional[Dict[str, int]] = None
        self._widx_sig = None
        self._use_default = False
        self.refreshes = 0
        self.triggered_at: List[float] = []
        self.last_reason = ""

    # -- observation hooks (called by the policies) ---------------------

    def observe_arrival(self, job, cluster, now: float, region: str = ""):
        if not self.detect:
            return
        mw = self._mix.get(region)
        if mw is None:
            mw = self._mix[region] = _MixWindow(
                self.window, self.threshold, self.confirm)
        if mw.add(job.engine):
            self.last_reason = "mix:%s" % (region or "global")
            self.refresh(cluster, now)

    def observe_complete(self, result, cluster, now: float,
                         use_default: bool = False):
        if not self.detect:
            return
        self._use_default = use_default
        e = result.job.engine
        wi = self._worker_index(cluster).get(result.worker)
        if wi is None:
            return
        if (result.prefill_worker is not None
                and result.prefill_worker != result.worker):
            # disaggregated job served by two pools: the solo seconds mix
            # both workers' physics, so the sample attributes to neither
            return
        # observable: the job's *solo* service seconds against the
        # profile model's own prediction for it — their ratio is exactly
        # ``slowdown * exec noise``, free of batch contention, transfer
        # time and service-model approximation error.  The prediction is
        # read through the *current beliefs* (the profile overlay's
        # scale for this cell): a correct refresh drives future
        # residuals back to zero and the detector goes quiet, an
        # under-corrected one keeps deviating and re-fires — successive
        # compositions converge on the true factor
        obs, pred = result.service_s, result.service_pred_s
        if math.isnan(obs) or math.isnan(pred) or pred <= 0 or obs <= 0:
            return
        scale = float(profile_overlay(cluster.cd, self.profile)
                      .factors(e, cluster.arrays.names)[wi])
        if scale > 0:
            pred = pred / scale
        clamp = math.log(self.resid_clamp)
        lr = max(-clamp, min(clamp, math.log(obs / pred)))
        if self._resid.add(e, result.worker, lr):
            self.last_reason = "residual"
            self.refresh(cluster, now)

    # -- refresh ---------------------------------------------------------

    def refresh(self, cluster, now: float):
        """Re-fit effective service rates from the recent completions
        and compose the corrections onto the current beliefs.  A
        mix-triggered refresh re-anchors the mix windows (a new traffic
        regime); the residual anchor is never reset — residuals are
        belief-relative, so a fully corrected drift returns to the
        anchor level by itself and a partial one re-fires."""
        updates = self._refit(cluster)
        if updates:
            profile_overlay(cluster.cd, self.profile).apply(updates)
            self.refreshes += 1
            self.triggered_at.append(now)
            # beliefs moved: buffered belief-relative samples are from
            # the old epoch, drop them (the anchor stays)
            self._resid.epoch_reset()
        if self.last_reason.startswith("mix"):
            for mw in self._mix.values():
                mw.reset()

    def seed(self, cluster, worker_factors: Optional[Dict[str, float]]
             = None, engine_factors: Optional[Dict[str, float]] = None,
             use_default: bool = False):
        """Oracle: install the refresh for the *true* drift — observed
        slowdown factors per worker and/or per engine (1.0 = on-profile,
        3.0 = three times slower than characterized) — with no detection
        or re-fit latency.  The benchmark's upper bound."""
        self._use_default = use_default
        wf = worker_factors or {}
        ef = engine_factors or {}
        cd = cluster.cd
        names = cluster.arrays.names
        tok = cluster.worker_token
        updates: Dict[str, Dict[str, float]] = {}
        for e in engine_catalogue():
            qps, _pre, _f = engine_rows(cd, e, names,
                                        use_default=use_default, token=tok)
            scales = {}
            for i, w in enumerate(names):
                if qps[i] <= 0:
                    continue
                f = wf.get(w, 1.0) * ef.get(e, 1.0)
                if f != 1.0:
                    scales[w] = self._clamp_scale(1.0 / f)
            if scales:
                updates[e] = scales
        if updates:
            profile_overlay(cd, self.profile).apply(updates)
            self.refreshes += 1
            self.triggered_at.append(0.0)
            self.last_reason = "seed"

    def _refit(self, cluster) -> Dict[str, Dict[str, float]]:
        """Backfit residual decomposition over the firing window's
        samples (the post-drift evidence itself — a recency deque would
        dilute it with pre-drift history): ``log f_{e,w} = m + a_e +
        b_w`` with worker effects ``b_w = mean_w - m`` first, then
        engine effects net of them, ``a_e = mean_e(lr - m - b_w)``, so a
        throttled pool doesn't leak into the effect of every engine it
        served.  Margins with fewer than ``min_count`` samples
        contribute zero.  In batched serving the global ``m`` is
        dropped — the depth penalty already models the uniform batch
        bias."""
        # prefer the current epoch's buffer (post-last-refresh samples);
        # a window-close fire just moved it into last_buf, a rolling
        # fire mid-window may leave it short — fall back then
        buf = self._resid.buf
        data = buf if len(buf) >= 2 * self._min_count else (
            self._resid.last_buf or buf)
        if len(data) < 2 * self._min_count or self._resid.anchor is None:
            return {}
        # every effect is measured *relative to the anchor* (which holds
        # the no-drift residual level — the exec-noise log-mean is
        # -sigma^2/2, not 0 — plus any per-margin model bias) and
        # installed only when it clears the same z-significance bar the
        # detector uses: a trigger with no real physics deviation (e.g.
        # an arrival-mix shift) refits to *zero updates* and the
        # schedule stays bit-for-bit unchanged
        m0, wrel0, erel0, s0 = self._resid.anchor
        z = self._resid.z

        def gate(eff: float, c: int) -> float:
            return eff if abs(eff) > z * s0 / math.sqrt(c) else 0.0

        m = sum(lr for _e, _w, lr in data) / len(data)
        m_term = gate(m - m0, len(data))
        wsum: Dict[str, float] = {}
        wcnt: Dict[str, int] = {}
        for _e, w, lr in data:
            wsum[w] = wsum.get(w, 0.0) + lr
            wcnt[w] = wcnt.get(w, 0) + 1
        b = {}
        for w in wsum:
            if wcnt[w] >= self._min_count:
                eff = gate(wsum[w] / wcnt[w] - m - wrel0.get(w, 0.0),
                           wcnt[w])
                if eff:
                    b[w] = eff
        # the per-worker rolling deques override the window means: they
        # hold only the newest (post-previous-refresh) samples, so they
        # are less diluted by jobs dispatched before the drift onset
        # whose residuals straddle the window — and a pool too slow to
        # reach min_count inside the firing data still has its
        # cross-window evidence here
        for w, (wm, c) in self._resid.worker_evidence().items():
            if c >= self._min_count:
                eff = gate(wm - m - wrel0.get(w, 0.0), c)
                if eff:
                    b[w] = eff
                else:
                    b.pop(w, None)
        esum: Dict[str, float] = {}
        ecnt: Dict[str, int] = {}
        for e, w, lr in data:
            esum[e] = esum.get(e, 0.0) + lr - m - b.get(w, 0.0)
            ecnt[e] = ecnt.get(e, 0) + 1
        a = {}
        for e in esum:
            if ecnt[e] >= self._min_count:
                eff = gate(esum[e] / ecnt[e] - erel0.get(e, 0.0), ecnt[e])
                if eff:
                    a[e] = eff
        if not (m_term or a or b):
            return {}
        cd = cluster.cd
        names = cluster.arrays.names
        tok = cluster.worker_token
        ov = profile_overlay(cd, self.profile)
        updates: Dict[str, Dict[str, float]] = {}
        for e in engine_catalogue():
            qps, _pre, _f = engine_rows(cd, e, names,
                                        use_default=self._use_default,
                                        token=tok)
            base = ov.factors(e, names)
            scales = {}
            touched = False
            for i, w in enumerate(names):
                if qps[i] <= 0:
                    continue
                logf = m_term + a.get(e, 0.0) + b.get(w, 0.0)
                # belief-relative correction: compose onto the factor
                # already installed, so repeated refreshes converge on
                # the true drift instead of re-deriving it from scratch
                scales[w] = self._clamp_scale(float(base[i])
                                              * math.exp(-logf))
                if abs(logf) > 1e-9:
                    touched = True
            if touched and scales:
                updates[e] = scales
        return updates

    def _clamp_scale(self, s: float) -> float:
        return max(1.0 / self.resid_clamp, min(self.resid_clamp, s))

    def _worker_index(self, cluster) -> Dict[str, int]:
        sig = (cluster.serial, cluster._member_gen)
        if self._widx is None or self._widx_sig != sig:
            self._widx = {w: i
                          for i, w in enumerate(cluster.arrays.names)}
            self._widx_sig = sig
        return self._widx
