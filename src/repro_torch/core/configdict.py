# Port of repro/core/configdict.py: the same numpy code, imports rewritten to repro_torch.
"""The Configuration Dictionary — output of the offline phase (paper §4.1,
block 1E).  For every (engine, worker) it stores the optimal configuration
c*_{j,w} (max QPS), the profiled pre-processing time, and the full DSE table
for the characterization benchmarks."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Entry:
    engine: str
    worker: str
    mode: str
    chips_per_replica: int
    qps: float
    query_time_s: float
    preproc_s: float
    power_w: float
    energy_per_query_j: float
    bottleneck: str
    # fraction of query_time_s spent in the per-token decode phase (vs the
    # prefill phase) — the serving bridge splits exec_time into token rates
    # with it.  Defaulted so ConfigDicts serialized before the field existed
    # still load.
    decode_frac: float = 0.85
    # static/idle power floor of the slice at this mode (W) — what a busy
    # worker burns during WAN-transfer seconds and an idle worker burns
    # while parked.  Defaulted for the same serialization reason.
    idle_power_w: float = 0.0


class ConfigDict:
    def __init__(self):
        self.best: Dict[str, Dict[str, Entry]] = {}       # engine -> worker -> c*
        self.default: Dict[str, Dict[str, Entry]] = {}    # default-config perf
        self.table: list[Entry] = []                      # full DSE table

    def add(self, entry: Entry, is_best=False, is_default=False):
        self.table.append(entry)
        if is_best:
            self.best.setdefault(entry.engine, {})[entry.worker] = entry
        if is_default:
            self.default.setdefault(entry.engine, {})[entry.worker] = entry

    def optimal(self, engine: str, worker: str) -> Optional[Entry]:
        # elastic clones are named "<pool>__<n>" and share the pool profile
        return self.best.get(engine, {}).get(worker.split("__")[0])

    def default_entry(self, engine: str, worker: str) -> Optional[Entry]:
        return self.default.get(engine, {}).get(worker.split("__")[0])

    def workers_for(self, engine: str) -> list[str]:
        return sorted(self.best.get(engine, {}),
                      key=lambda w: -self.best[engine][w].qps)

    # ---- persistence -------------------------------------------------------
    def to_json(self, path: str):
        blob = {
            "best": {e: {w: dataclasses.asdict(ent) for w, ent in ws.items()}
                     for e, ws in self.best.items()},
            "default": {e: {w: dataclasses.asdict(ent)
                            for w, ent in ws.items()}
                        for e, ws in self.default.items()},
            "table": [dataclasses.asdict(e) for e in self.table],
        }
        with open(path, "w") as f:
            json.dump(blob, f, indent=1)

    @classmethod
    def from_json(cls, path: str) -> "ConfigDict":
        with open(path) as f:
            blob = json.load(f)
        cd = cls()
        cd.table = [Entry(**e) for e in blob["table"]]
        cd.best = {e: {w: Entry(**ent) for w, ent in ws.items()}
                   for e, ws in blob["best"].items()}
        cd.default = {e: {w: Entry(**ent) for w, ent in ws.items()}
                      for e, ws in blob["default"].items()}
        return cd
