"""Schedule a fleet-scale scenario with SynergAI scored on the card.

The port's entry point: characterize the fleet offline, draw a scenario's
jobs, run the event-heap simulator with ``SynergAI`` scored by the CUDA
kernels (``--v2`` for the fused batched/streaming kernel, ``--resident`` for
the device-resident tick), and print the run's summary as JSON.
``--regions K`` tags the fleet with K regions, draws per-region traffic
(``regional_scenario``) and schedules it with ``HierarchicalSynergAI``.

    PYTHONPATH=src python -m repro_torch.launch.schedule [--jobs 10000]
        [--pools 8 28 28] [--serving batched --streaming 2.0 2.5]
        [--v2 | --resident] [--regions K] [--device cpu]

Without ``--device cpu`` it needs a Hopper card.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.hierarchy import HierarchicalSynergAI
from repro_torch.core.metrics import summarize
from repro_torch.core.offline import characterize
from repro_torch.core.scheduler import SynergAI
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.core.simulator import Simulator
from repro_torch.core.workers import synth_fleet
from repro_torch.core.workload import SCENARIOS, regional_scenario, scenario


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kind", choices=SCENARIOS, default="mmpp")
    p.add_argument("--jobs", type=int, default=10_000)
    p.add_argument("--pools", type=int, nargs=3, default=(8, 28, 28),
                   metavar=("CLOUD", "EDGE_LG", "EDGE_SM"))
    p.add_argument("--serving", choices=("job", "batched"), default="job")
    p.add_argument("--streaming", type=float, nargs=2, default=None,
                   metavar=("TTFT_SCALE", "TPOT_SCALE"),
                   help="streaming TTFT/TPOT deadline scales "
                        "(batched serving only)")
    backend = p.add_mutually_exclusive_group()
    backend.add_argument("--v2", action="store_true",
                         help="score with the fused v2 kernel")
    backend.add_argument("--resident", action="store_true",
                         help="run the device-resident tick "
                              "(DeviceScoreCache + scheduler_tick)")
    p.add_argument("--regions", type=int, default=None, metavar="K",
                   help="K-region fleet, per-region traffic, "
                        "HierarchicalSynergAI")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain PyTorch versions; "
                        "default: the CUDA card")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    score_fn = make_torch_score_fn(v2=args.v2, device=args.device,
                                   device_cache=args.resident)
    cd = characterize()
    fleet = synth_fleet(*args.pools, regions=args.regions or 0)
    draw = scenario if args.regions is None else regional_scenario
    jobs = draw(cd, args.kind, n_jobs=args.jobs, fleet=fleet, seed=args.seed,
                serving=args.serving,
                streaming=tuple(args.streaming) if args.streaming else None)
    policy = (SynergAI if args.regions is None
              else HierarchicalSynergAI)(score_fn=score_fn)
    sim = Simulator(cd, policy, fleet=fleet, seed=args.seed,
                    serving=args.serving)
    t0 = time.perf_counter()
    results = sim.run(jobs)
    stats = summarize(results)
    stats["wall_s"] = time.perf_counter() - t0
    stats["device"] = str(score_fn.device)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
