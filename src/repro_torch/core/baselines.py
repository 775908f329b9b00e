# Port of repro/core/baselines.py: the same numpy code, imports rewritten to repro_torch.
"""Baseline scheduling policies (paper §5.1): RR, SRR, LRU, MRU, BE.

All baselines use each device's *default configuration* regardless of job
requirements (paper §5.4: "these schedulers utilize the default
configuration of each device").

Dispatch goes through ``Cluster.admit_ok`` — plain idleness in job mode,
plus the serving bridge's batch-formation rules (same-engine batches under
slot/KV budgets) when the simulator runs with ``serving="batched"``, plus
the phase-role match under prefill/decode-disaggregated pools
(``WorkerPool.role``): a baseline never lands a decode phase on a
prefill-only pool.  That is the whole of their streaming awareness — by
design they keep ignoring TTFT/TPOT deadlines, exactly as they ignore
``t_qos`` (paper §5.4), which is what ``bench_streaming`` measures them
against.
"""

from __future__ import annotations

import math
from typing import List

from repro_torch.core.simulator import Assignment, Cluster, Policy


def _entry(cluster: Cluster, engine: str, worker: str, use_default=True):
    ent = (cluster.cd.default_entry(engine, worker) if use_default
           else cluster.cd.optimal(engine, worker))
    if ent is None or ent.qps <= 0:
        return None
    return ent


class RoundRobin(Policy):
    name = "RR"

    def __init__(self):
        self.ptr = 0

    def schedule(self, now, queue, cluster) -> List[Assignment]:
        names = list(cluster.workers)
        out, taken = [], set()
        for job in list(queue):
            placed = False
            for off in range(len(names)):
                w = names[(self.ptr + off) % len(names)]
                if w in taken or not cluster.admit_ok(job, w, now):
                    continue
                ent = _entry(cluster, job.engine, w)
                if ent is None:
                    continue
                out.append(Assignment(job, w, ent))
                taken.add(w)
                self.ptr = (self.ptr + off + 1) % len(names)
                placed = True
                break
            if not placed:
                break  # FIFO: don't skip ahead of the blocked head
        return out


class StrictRoundRobin(Policy):
    """Head job strictly waits for the next worker in rotation."""

    name = "SRR"

    def __init__(self):
        self.ptr = 0

    def schedule(self, now, queue, cluster) -> List[Assignment]:
        if not queue:
            return []
        names = list(cluster.workers)
        job = queue[0]
        # advance past workers that can never run this engine
        for _ in range(len(names)):
            w = names[self.ptr % len(names)]
            if _entry(cluster, job.engine, w) is not None:
                break
            self.ptr += 1
        w = names[self.ptr % len(names)]
        if not cluster.admit_ok(job, w, now):
            return []  # strict: wait for this specific worker
        ent = _entry(cluster, job.engine, w)
        self.ptr += 1
        return [Assignment(job, w, ent)]


class LeastRecentlyUsed(Policy):
    name = "LRU"

    def schedule(self, now, queue, cluster) -> List[Assignment]:
        out, taken = [], set()
        for job in list(queue):
            idle = [(cluster.workers[w].last_freed, w)
                    for w in cluster.idle_workers(now)
                    if w not in taken
                    and cluster.admit_ok(job, w, now)
                    and _entry(cluster, job.engine, w) is not None]
            if not idle:
                break
            _, w = min(idle)
            out.append(Assignment(job, w, _entry(cluster, job.engine, w)))
            taken.add(w)
        return out


class MostRecentlyUsed(Policy):
    name = "MRU"

    def schedule(self, now, queue, cluster) -> List[Assignment]:
        out, taken = [], set()
        for job in list(queue):
            idle = [(cluster.workers[w].last_freed, w)
                    for w in cluster.idle_workers(now)
                    if w not in taken
                    and cluster.admit_ok(job, w, now)
                    and _entry(cluster, job.engine, w) is not None]
            if not idle:
                break
            _, w = max(idle)
            out.append(Assignment(job, w, _entry(cluster, job.engine, w)))
            taken.add(w)
        return out


class BestEffort(Policy):
    """Greedy: iterate from the strongest worker to the weakest."""

    name = "BE"

    def schedule(self, now, queue, cluster) -> List[Assignment]:
        strength = sorted(
            cluster.workers,
            key=lambda w: -(cluster.workers[w].pool.chip_flops
                            * cluster.workers[w].pool.n_chips))
        out, taken = [], set()
        for job in list(queue):
            placed = False
            for w in strength:
                if w in taken or not cluster.admit_ok(job, w, now):
                    continue
                ent = _entry(cluster, job.engine, w)
                if ent is None:
                    continue
                out.append(Assignment(job, w, ent))
                taken.add(w)
                placed = True
                break
            if not placed:
                break
        return out
