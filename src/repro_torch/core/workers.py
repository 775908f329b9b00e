# Port of repro/core/workers.py: the same numpy code, imports rewritten to repro_torch.
"""Heterogeneous worker fleet: TPU slices with operating modes.

TPU-native analogue of the paper's testbed (§3.1): an x86 cloud VM plus two
ARM edge boards with mode tables.  Here: one 16-chip cloud slice and two
smaller edge slices whose operating modes mirror Table 2 row-for-row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.constants import (AGX_LIKE_MODES, CLOUD_MODES, HBM_BW,
                                  HBM_BYTES, NX_LIKE_MODES, PEAK_FLOPS_BF16,
                                  V5P_FLOPS_BF16, V5P_HBM_BW, V5P_HBM_BYTES,
                                  OperatingMode)


@dataclasses.dataclass(frozen=True)
class WorkerPool:
    name: str
    n_chips: int                     # physical chips in the slice
    modes: tuple                     # available operating modes
    mesh_shape: tuple                # physical topology
    is_edge: bool
    chip_flops: float = PEAK_FLOPS_BF16   # per-chip bf16 peak
    chip_hbm_bw: float = HBM_BW
    chip_hbm_bytes: float = HBM_BYTES
    # phase specialization under the disaggregated serving bridge
    # (docs/serving_bridge.md): "both" serves whole jobs (and either phase
    # in a disaggregated cluster); "prefill"/"decode" pools only admit that
    # phase.  Requires ``Simulator(..., serving="batched")``.
    role: str = "both"
    # shared-infrastructure grouping for correlated failure traces
    # (``workload.synth_failures(regions=True)``): pools in one region
    # share power/network and go down together in a regional outage.
    # "" means ungrouped.
    region: str = ""

    @property
    def default_mode(self) -> OperatingMode:
        # The "default configuration" baselines use (paper §5.2: schedulers
        # without the offline phase "rely on predefined configurations,
        # typically selecting the worker with the highest CPU resources"):
        # the stock mode with the most chips online — which, as on real
        # Jetson boards, is a low-clock mode, not MAXN.
        most_chips = max(m.chips_online for m in self.modes)
        cands = [m for m in self.modes if m.chips_online == most_chips]
        return min(cands, key=lambda m: m.clock_scale)

    def hbm_capacity(self, mode: OperatingMode) -> int:
        return min(mode.chips_online, self.n_chips) * self.chip_hbm_bytes

    @property
    def idle_power_w(self) -> float:
        """The pool's static floor while parked: the cheapest idle draw
        across its mode table (a board waiting for work throttles to its
        lowest operating point)."""
        return min(m.idle_power_w() for m in self.modes)


def power_capped_fleet(fleet, cap_w: float,
                       edge_only: bool = True) -> List[WorkerPool]:
    """Energy-capped scenario helper: throttle pools to a power budget
    instead of failing them.

    Each matching pool keeps only the operating modes whose full-load draw
    fits ``cap_w``; if none fit, the pool throttles to its lowest-draw mode
    with ``power_budget_w`` clamped to the cap (the board brown-outs to its
    floor rather than going dark — paper Key Outcome 4: the budget shapes
    which modes are *enabled*).  The capped pools re-characterize to
    different optimal configurations, so run ``offline.characterize`` on
    the returned fleet.  ``edge_only`` leaves cloud pools untouched (the
    usual scenario: a site-level budget on the edge boxes).
    """
    out: List[WorkerPool] = []
    for pool in fleet:
        if edge_only and not pool.is_edge:
            out.append(pool)
            continue
        fits = tuple(m for m in pool.modes if m.power_w() <= cap_w)
        if not fits:
            low = min(pool.modes, key=lambda m: m.power_w())
            fits = (dataclasses.replace(
                low, power_budget_w=min(low.power_budget_w, cap_w)),)
        out.append(dataclasses.replace(pool, modes=fits))
    return out


def default_fleet() -> List[WorkerPool]:
    """Cloud pod = v5p-class chips (the paper's x86 server analogue: the
    most powerful node); edge slices = v5e-class with mode tables."""
    return [
        WorkerPool("cloud-pod", 16, tuple(CLOUD_MODES), (4, 4), False,
                   chip_flops=V5P_FLOPS_BF16, chip_hbm_bw=V5P_HBM_BW,
                   chip_hbm_bytes=V5P_HBM_BYTES),
        WorkerPool("edge-large", 8, tuple(AGX_LIKE_MODES), (2, 4), True),
        WorkerPool("edge-small", 6, tuple(NX_LIKE_MODES), (2, 3), True),
    ]


def synth_fleet(n_cloud: int = 1, n_edge_large: int = 1,
                n_edge_small: int = 1,
                disaggregate=False, regions: int = 0) -> List[WorkerPool]:
    """Synthetic fleet: replicate the three profiled pool archetypes.

    Replica k > 0 of an archetype is named ``<archetype>__<k+1>`` so it
    shares the archetype's Configuration Dictionary profile (see
    ``ConfigDict.optimal``, which strips the ``__`` suffix): a single
    ``characterize()`` over the 3-pool default fleet drives simulations of
    any fleet size — e.g. ``synth_fleet(8, 28, 28)`` is a 64-pool cluster.

    ``disaggregate`` tags replicas for prefill/decode-disaggregated
    serving (``serving="batched"`` only): within each archetype a
    ``prefill``-only share of the replicas (``True`` → 25%, or pass a
    float fraction; at least one when the archetype has ≥ 2 replicas —
    prefill is the short, compute-hot phase) and the rest ``decode``-only.
    Splitting *within* each archetype keeps every engine feasible in both
    phases.  Singleton archetypes stay ``role="both"`` so no engine loses
    a phase.  For explicit placements (e.g. cloud-archetype prefill +
    edge-archetype decode) build the fleet manually and set
    ``dataclasses.replace(pool, role=...)``.

    ``regions > 0`` tags pools with region labels ``r0..r<regions-1>``
    round-robin across the whole fleet, so every region holds a mix of
    archetypes (a regional outage degrades the fleet instead of wiping
    out one archetype).  Feed the tagged fleet to
    ``workload.synth_failures(..., regions=True)`` for correlated
    multi-region failure traces.
    """
    assert n_cloud + n_edge_large + n_edge_small > 0, "empty fleet"
    prefill_frac = 0.25 if disaggregate is True else float(disaggregate)
    out: List[WorkerPool] = []
    counts = (n_cloud, n_edge_large, n_edge_small)
    for pool, n in zip(default_fleet(), counts):
        n_prefill = (min(n - 1, max(1, round(prefill_frac * n)))
                     if n >= 2 else 0)
        for k in range(n):
            name = pool.name if k == 0 else f"{pool.name}__{k + 1}"
            role = "both"
            if disaggregate and n >= 2:
                role = "prefill" if k < n_prefill else "decode"
            out.append(dataclasses.replace(pool, name=name, role=role))
    if regions:
        out = [dataclasses.replace(w, region=f"r{i % regions}")
               for i, w in enumerate(out)]
    return out


def fleet_by_name(fleet=None) -> Dict[str, WorkerPool]:
    return {w.name: w for w in (fleet or default_fleet())}


def region_groups(fleet) -> Dict[str, List[WorkerPool]]:
    """Pools grouped by region tag, in fleet order within each group and
    first-sighting order across groups (the canonical region ordering
    used by ``repro.core.hierarchy``).  An untagged fleet collapses to
    one ``""`` group — which is exactly the hierarchy's flat-equivalence
    case."""
    out: Dict[str, List[WorkerPool]] = {}
    for w in fleet:
        out.setdefault(w.region, []).append(w)
    return out
