# Port of repro/core/overload.py: the same numpy code, imports rewritten to repro_torch.
"""Deadline-aware load shedding + admission backpressure (docs/robustness.md).

Under sustained overload every queue-growing policy in this repo used to
pay twice: certainly-doomed jobs (already past the point where even the
fleet's best estimate misses their QoS) still occupied worker slots that
feasible jobs needed, and the queue itself grew without bound.  The
``OverloadController`` is the shared shed/backpressure brain consulted by
``SynergAI`` and (per region) ``HierarchicalSynergAI`` during
``schedule``:

* **doom shedding** — the cached ``t_rem < min_est`` predicate from the
  lazy-placement path: ``min_est`` is the job's *best possible* service
  estimate across the fleet (already maintained cross-tick by the
  ``ScoreCache``), so a job whose remaining QoS budget is below it cannot
  complete in time no matter what the scheduler does.  Shedding it is
  O(1) per shed against already-maintained state, and — because the
  depth-penalty factor is always >= 1 — the unpenalized predicate is a
  *certain*-doom test under batching too.
* **queue-depth admission backpressure** — with ``queue_cap`` set, only
  the cap-most-schedulable jobs (the scheduler's own
  ``lexsort((urgency, doomed))`` priority order) stay queued; the excess
  is shed while still fresh instead of aging into doom.  Under the
  hierarchical scheduler each region consults separately, so the cap is
  per region.

The policy only *marks* sheds (and excludes them from placement); the
``Simulator`` drains the marks after each ``schedule`` call and closes
the jobs out with terminal ``JobResult(outcome="shed")`` — policies never
mutate the queue.  A policy constructed without a controller (the
default) takes none of these branches, keeping every historical schedule
bit-for-bit.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.job import Job


class OverloadController:
    """Shed/backpressure decisions for one scheduling policy.

    Parameters
    ----------
    shed_doomed:
        Shed jobs whose remaining QoS budget is below their best-case
        service estimate (``t_rem < min_est``).  Default on.
    queue_cap:
        Admission backpressure: after doom shedding, keep at most this
        many jobs per consulted queue (per region under the hierarchical
        scheduler), shedding from the tail of the scheduler's own
        priority order.  ``None`` (default) means unbounded.
    """

    def __init__(self, shed_doomed: bool = True,
                 queue_cap: Optional[int] = None):
        self.shed_doomed = shed_doomed
        self.queue_cap = queue_cap
        self._pending: List[Job] = []
        # counters (introspection / bench reporting)
        self.shed_doom_total = 0
        self.shed_backpressure_total = 0

    def consult(self, now: float, queue: List[Job], doomed: np.ndarray,
                urgency: np.ndarray) -> Optional[np.ndarray]:
        """Mark sheds for one queue: ``doomed`` is the caller's certain-
        doom mask, ``urgency`` its placement-priority key (lower = served
        sooner).  Returns a bool mask over ``queue`` of jobs the caller
        must skip during placement (``None`` when nothing sheds), and
        records the marked jobs for ``Simulator`` to drain."""
        J = len(queue)
        if J == 0:
            return None
        shed = np.zeros(J, dtype=bool)
        if self.shed_doomed:
            shed |= doomed
            self.shed_doom_total += int(shed.sum())
        cap = self.queue_cap
        if cap is not None:
            alive = J - int(shed.sum())
            if alive > cap:
                # keep the cap-most-schedulable survivors: the same
                # (urgency, doomed-last) order the placement walk uses
                order = np.lexsort((urgency, shed))
                drop = order[cap:]
                drop = drop[~shed[drop]]
                shed[drop] = True
                self.shed_backpressure_total += len(drop)
        if not shed.any():
            return None
        pend = self._pending
        for ji in np.nonzero(shed)[0]:
            pend.append(queue[ji])
        return shed

    def drain(self) -> List[Job]:
        """Hand the marked jobs to the simulator (clears the marks)."""
        out, self._pending = self._pending, []
        return out
