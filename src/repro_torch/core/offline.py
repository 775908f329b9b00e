# Port of repro/core/offline.py: the same numpy code, imports rewritten to repro_torch.
"""Offline phase: architecture-driven performance analysis & characterization
(paper §4.1).

Performance-aware Configuration Generator (1A): enumerate chips-per-replica
(the vertical-scaling analogue of thread counts).
Architecture-aware Configuration Generator (1B): enumerate operating modes.
Design Space Exploration (1C) -> Optimal Deployments (1D) -> Configuration
Dictionary (1E).

Also implements the paper's cold-start heuristics for *new* devices/engines
(§4.2 "Incorporating new devices and inference engines").
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

from repro_torch.core.configdict import ConfigDict, Entry
from repro_torch.core.engines import EngineSpec, default_engines
from repro_torch.core.perfmodel import ConfigPoint, config_space, estimate
from repro_torch.core.workers import WorkerPool, default_fleet


def _entry(engine: EngineSpec, worker: WorkerPool, point: ConfigPoint):
    est = estimate(engine, worker, point)
    if not est.feasible:
        return None
    return Entry(engine.name, worker.name, point.mode.name,
                 point.chips_per_replica, est.qps, est.query_time_s,
                 est.preproc_s, est.power_w, est.energy_per_query_j,
                 est.bottleneck, est.decode_frac, est.idle_power_w)


def characterize(engines: Optional[Dict[str, EngineSpec]] = None,
                 fleet: Optional[Iterable[WorkerPool]] = None) -> ConfigDict:
    """Full DSE over (engine x worker x mode x chips-per-replica)."""
    engines = engines or default_engines()
    fleet = list(fleet or default_fleet())
    cd = ConfigDict()
    for ename, engine in engines.items():
        for worker in fleet:
            best = None
            entries = []
            for point in config_space(engine, worker):
                ent = _entry(engine, worker, point)
                if ent is None:
                    continue
                entries.append(ent)
                if best is None or ent.qps > best.qps:
                    best = ent
            # the default configuration (baselines use this): all chips at
            # the default (max) mode
            dmode = worker.default_mode
            dpoint = ConfigPoint(dmode, min(dmode.chips_online,
                                            worker.n_chips))
            dent = _entry(engine, worker, dpoint)
            for ent in entries:
                cd.add(ent,
                       is_best=(ent is best),
                       is_default=(dent is not None
                                   and ent.mode == dent.mode
                                   and ent.chips_per_replica
                                   == dent.chips_per_replica))
            if dent is not None and dent not in entries:
                cd.add(dent, is_default=True)
    return cd


def cold_start_config(worker: WorkerPool) -> ConfigPoint:
    """Paper §4.2 heuristic for a new, un-characterized device: pick the
    highest frequency; among similar frequencies prefer the second-highest
    chip count (diminishing returns past that)."""
    best_clock = max(m.effective_clock() for m in worker.modes)
    near = [m for m in worker.modes
            if m.effective_clock() >= 0.95 * best_clock]
    counts = sorted({min(m.chips_online, worker.n_chips) for m in near})
    target = counts[-2] if len(counts) > 1 else counts[-1]
    mode = max(near, key=lambda m: (min(m.chips_online, worker.n_chips)
                                    == target, m.effective_clock()))
    return ConfigPoint(mode, min(target, worker.n_chips))
