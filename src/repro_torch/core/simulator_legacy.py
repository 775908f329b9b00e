# Port of repro/core/simulator_legacy.py: the same numpy code, imports rewritten to repro_torch.
"""The seed's tick-scanning simulator loop, preserved as a reference.

``LegacySimulator`` keeps the original ``Simulator.run`` structure: every
iteration rescans all workers, remaining failures and running jobs to find
the next event.  It exists for two reasons:

1. It is the *semantics oracle* — the event-heap engine in
   ``repro_torch.core.simulator`` must reproduce its ``JobResult`` stream exactly
   (see ``tests/test_simulator_engine.py``).
2. It is the "old" side of the old-vs-new wall-clock comparison in
   ``benchmarks/scheduler_experiments.py``.

All per-assignment mechanics (``_start``, ``_speculate``, ``_elastic``) are
inherited, so the two engines share a single implementation of execution
noise, stragglers, speculation and elastic scaling; with ``self._heap``
left as ``None`` the event-heap notification hooks are no-ops here.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence

from repro_torch.core.job import Job
from repro_torch.core.simulator import JobResult, Simulator


class LegacySimulator(Simulator):
    name = "legacy"

    def run(self, jobs: Sequence[Job]) -> List[JobResult]:
        if getattr(self, "serving", "job") != "job":
            raise NotImplementedError(
                "LegacySimulator predates the serving bridge; "
                "serving='batched' runs on the event-heap Simulator only")
        # new run, new world (see Simulator.run): flush score caches
        self.cluster._fail_gen += 1
        pending = sorted(jobs, key=lambda j: j.arrival)
        queue: List[Job] = []
        results: List[JobResult] = []
        running: Dict[int, JobResult] = {}
        first_attempt: Dict[int, float] = {}
        decision_time: Dict[int, float] = {}
        failures = list(self.failures)
        now = 0.0
        n_total = len(pending)

        def next_event() -> float:
            cands = []
            if pending:
                cands.append(pending[0].arrival)
            busy = [w.busy_until for w in self.cluster.workers.values()
                    if w.busy_until > now]
            cands += busy
            fail = [f.at for f in failures if f.at > now]
            cands += fail
            recov = [w.failed_until for w in self.cluster.workers.values()
                     if w.failed_until > now]
            cands += recov
            if queue and self.tick:
                cands.append(now + self.tick)
            if running and self.speculative and self.tick:
                cands.append(now + self.tick)  # straggler watchdog
            return min(cands) if cands else math.inf

        guard = 0
        while len(results) < n_total:
            guard += 1
            assert guard < 2_000_000, "simulator livelock"
            # 1) deliver arrivals
            while pending and pending[0].arrival <= now + 1e-12:
                job = pending.pop(0)
                queue.append(job)
                self.policy.on_arrival(job, self.cluster, now)
            # 2) worker failures: kill the running job, re-queue it
            while failures and failures[0].at <= now + 1e-12:
                f = failures.pop(0)
                w = self.cluster.workers[f.worker]
                w.failed_until = f.at + f.duration
                for jid, rec in list(running.items()):
                    if rec.worker == f.worker and rec.end > now:
                        del running[jid]
                        w.busy_until = now
                        queue.append(rec.job)   # checkpoint-restart: requeue
            # 3) complete finished jobs
            for jid, rec in list(running.items()):
                if rec.end <= now + 1e-12:
                    del running[jid]
                    results.append(rec)
                    w = self.cluster.workers[rec.worker]
                    w.last_freed = rec.end
            # 3b) straggler mitigation
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
                decision_time[a.job.id] = (decision_time.get(a.job.id, 0.0)
                                           + dt / max(1, len(assignments)))
            # track blocked head-of-line attempts (scheduling overhead)
            if not assignments and queue:
                for j in queue[:1]:
                    first_attempt.setdefault(j.id, now)
            for a in assignments:
                self._start(a, now, queue, running, first_attempt,
                            decision_time)
            # 5) advance time
            nxt = next_event()
            if nxt is math.inf and not running and queue:
                # every queued job is infeasible everywhere -> drop loudly
                raise RuntimeError(
                    f"stuck: {[j.engine for j in queue]} infeasible")
            if nxt is math.inf:
                break
            now = max(now, nxt)
        return results
