# Port of repro/core/energy.py: the same numpy code, imports rewritten to repro_torch.
"""Energy accounting (paper §5.4, Fig. 12).

TDP-methodology: energy = operating-point power x busy time, accumulated in
the simulator per worker pool (WAN-transfer seconds billed at the idle
floor, see ``simulator``).  Cloud (VM) energy is reported but flagged —
the paper omits cloud energy because VM attribution is not feasible; we keep
the same normalized-edge-energy headline plus the placement shares that
explain SLO-MAEL's higher overall footprint.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from repro_torch.core.simulator import Cluster, JobResult
from repro_torch.core.workers import default_fleet


def edge_energy(cluster: Cluster) -> Dict[str, float]:
    return {n: w.energy_j for n, w in cluster.workers.items()
            if w.pool.is_edge}


def idle_energy(cluster: Cluster) -> Dict[str, float]:
    """Per-worker static-floor joules burned while parked (settled by
    ``Simulator.run`` at end of run)."""
    return {n: w.idle_energy_j for n, w in cluster.workers.items()}


def normalized_edge_energy(clusters: Dict[str, Cluster]
                           ) -> Dict[str, Dict[str, float]]:
    """Per-policy edge energy, normalized by the per-pool max across
    policies (the paper's Fig. 12-left normalization).

    Policies may run disjoint fleets: a pool missing from a policy's
    cluster is *omitted* from that policy's row (it never existed there —
    reporting 0.0 would read as "ran cold"), and a pool whose peak across
    all policies is zero normalizes to 0.0 everywhere (nothing burned,
    not energy/1.0).
    """
    per_policy = {pol: edge_energy(c) for pol, c in clusters.items()}
    pools = set()
    for e in per_policy.values():
        pools |= set(e)
    peak = {p: max(e.get(p, 0.0) for e in per_policy.values())
            for p in pools}
    return {pol: {p: (0.0 if peak[p] <= 0.0 else e[p] / peak[p])
                  for p in pools if p in e}
            for pol, e in per_policy.items()}


def _is_edge_worker(worker: str, pools) -> bool:
    pool = pools.get(worker)
    if pool is None:
        # synth_fleet replicas ("cloud-pod__2") and elastic clones
        # ("edge-large__clone1") share the archetype's profile — and its
        # edge-ness
        pool = pools.get(worker.split("__")[0])
    return pool.is_edge if pool is not None else True


def offload_fraction(results: Sequence[JobResult],
                     cluster: Optional[Cluster] = None) -> float:
    """Fraction of jobs offloaded to (non-edge) cloud pools.

    Edge vs cloud resolves through ``WorkerPool.is_edge`` — pass the run's
    cluster so replicated (``cloud-pod__k``), regional and disaggregated
    fleets report correctly; without one, worker names fall back to the
    ``default_fleet`` archetypes (suffix-stripped).
    """
    if cluster is not None:
        pools = {n: ws.pool for n, ws in cluster.workers.items()}
    else:
        pools = {w.name: w for w in default_fleet()}
    cloud = sum(1 for r in results if not _is_edge_worker(r.worker, pools))
    return cloud / max(1, len(results))
