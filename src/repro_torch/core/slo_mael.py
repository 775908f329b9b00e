# Port of repro/core/slo_mael.py: the same numpy code, imports rewritten to repro_torch.
"""SLO-MAEL — SotA baseline reimplemented from Seo et al., TACO'21 (paper
[35]), without model slicing, as the paper's §5.3 comparison.

On each arrival it scores all job->worker mappings by *expected latency*
(current worker backlog + execution time with the worker's default
configuration) and commits the job to the worker minimizing expected latency
subject to the SLO when possible.  Decision-making happens at arrival
(a preprocessing step — zero runtime scheduling overhead, paper §5.4);
there is no adaptive re-scheduling and no per-engine configuration tuning —
the two capabilities SynergAI adds.

The arrival scoring is vectorized over the fleet: the engine's profiled
(qps, preproc, decode_frac) row comes from the shared
``estimator.engine_rows`` cache (one fancy index instead of W ConfigDict
lookups) and the depth penalty / role gates read the ``Cluster``
struct-of-arrays mirror, so a decision is a handful of O(W) vector ops.
The winner is the first index minimizing expected latency among
SLO-satisfying pools (falling back to all feasible pools) — exactly the
original scan's ``(ok and not best_ok) or (ok == best_ok and score <
best)`` tie-breaking, bit-for-bit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.engines import engine_catalogue
from repro_torch.core.estimator import engine_rows
from repro_torch.core.simulator import PHASE_CODE, Assignment, Cluster, Policy


class SloMael(Policy):
    name = "SLO-MAEL"

    def __init__(self, recharacterizer=None):
        self.backlog: Dict[str, float] = {}      # committed busy time
        self.mapping: Dict[int, str] = {}        # job id -> worker
        self.worker_fifo: Dict[str, List[int]] = {}
        # optional online re-characterization: the arrival plan reads the
        # overlay's belief-scaled default-config rows once it triggers
        self.recharacterizer = recharacterizer
        self.profile = recharacterizer.profile if recharacterizer else 0

    def on_complete(self, result, cluster, now):
        if self.recharacterizer is not None:
            self.recharacterizer.observe_complete(
                result, cluster, now,
                use_default=self.use_default_config)

    def on_arrival(self, job, cluster: Cluster, now: float):
        if self.recharacterizer is not None:
            self.recharacterizer.observe_arrival(job, cluster, now)
        self._plan(job, cluster, now)

    def _plan(self, job, cluster: Cluster, now: float):
        a = cluster.arrays
        names = a.names
        qps, pre, frac = engine_rows(cluster.cd, job.engine, names,
                                     use_default=True,
                                     token=cluster.worker_token,
                                     profile=self.profile)
        phase = cluster.phase_of(job)
        q = float(job.queries)
        with np.errstate(divide="ignore", invalid="ignore"):
            # full default-config service and its prefill prefix
            # (``serving_bridge.prefill_prefix``, vectorized)
            exec_q = q / qps
            full = pre + exec_q
            prefill = np.minimum(full, pre + exec_q * (1.0 - frac))
            if phase == "prefill":
                exec_s, prefill_s = prefill, prefill
            elif phase == "decode":
                exec_s, prefill_s = full - prefill, np.zeros(len(names))
            else:
                exec_s, prefill_s = full, prefill
            cand = qps > 0
            if cluster.disaggregated:
                cand &= (a.role == 0) | (a.role == PHASE_CODE[phase])
            if not cand.any():
                return
            # expected backlog from its *own* model-based bookkeeping
            # (the preprocessing-time plan) — it does not re-observe the
            # cluster, which is exactly the "no adaptive rescheduling"
            # limitation the paper calls out.  Under the batched serving
            # bridge the execution estimate is queue-depth-adjusted
            # (joining a live batch runs 1 + alpha*b slower); 1 in job
            # mode.
            wait = np.maximum(0.0, np.fromiter(
                (self.backlog.get(w, 0.0) for w in names),
                dtype=np.float64, count=len(names)) - now)
            pen = cluster.depth_penalty_array(now)
            exp_latency = wait + pen * exec_s
            ok = cand & (exp_latency <= job.t_qos)
            # streaming SLOs: the plan must clear every deadline the job
            # carries — the tighter of (latency, TTFT, TPOT) headroom
            req = job.request
            if (req is not None and req.ttft_qos is not None
                    and phase != "decode"):
                exp_ttft = (now - job.arrival) + wait + pen * prefill_s
                ok &= exp_ttft <= req.ttft_qos
            if (req is not None and req.tpot_qos is not None
                    and phase != "prefill"):
                # per-token rate over the engine-default token count: the
                # profile-shape decode seconds and the sampled Request
                # length would otherwise disagree on what "per token" means
                spec = engine_catalogue().get(job.engine)
                dtok = (job.queries * spec.decode_len if spec is not None
                        else req.decode_tokens)
                if dtok > 0:
                    decode_s = exec_s - (prefill_s if phase != "decode"
                                         else 0.0)
                    ok &= pen * decode_s / dtok <= req.tpot_qos
        # prefer SLO-satisfying mappings; break ties by expected latency
        # at the lowest index — argmin over the masked scores reproduces
        # the original first-strict-improvement scan exactly
        pick = ok if ok.any() else cand
        scores = np.where(pick, exp_latency, np.inf)
        wi = int(scores.argmin())
        best_w = names[wi]
        self.mapping[job.id] = best_w
        base = max(cluster.workers[best_w].busy_until,
                   self.backlog.get(best_w, now), now)
        self.backlog[best_w] = base + float(exec_s[wi])
        self.worker_fifo.setdefault(best_w, []).append(job.id)

    def schedule(self, now, queue, cluster) -> List[Assignment]:
        # failure recovery: a job killed mid-run is re-queued by the
        # simulator without a new arrival event, so it sits in no per-worker
        # FIFO and would never dispatch again — re-commit it as if it had
        # just arrived (its old backlog entry is a sunk cost the model-based
        # plan never revisits; that lack of re-observation is the paper's
        # §5.3 criticism of this baseline).  No-op without failures.
        committed = set()
        for fifo in self.worker_fifo.values():
            committed.update(fifo)
        for job in queue:
            if job.id not in committed:
                # re-commit without re-observing: a failure requeue is
                # not a new arrival, so the drift detector's mix window
                # never double-counts it
                self._plan(job, cluster, now)
        out = []
        by_id = {j.id: j for j in queue}
        for w, fifo in self.worker_fifo.items():
            if not fifo or not cluster.workers[w].idle(now):
                continue
            jid = fifo[0]
            if jid not in by_id:
                continue
            job = by_id[jid]
            if not cluster.admit_ok(job, w, now):
                continue    # batched: the live batch serves another engine
            ent = cluster.cd.default_entry(job.engine, w)
            out.append(Assignment(job, w, ent))
            fifo.pop(0)
        return out
