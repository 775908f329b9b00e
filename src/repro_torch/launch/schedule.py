"""Schedule a fleet-scale scenario with SynergAI scored on the card.

The port's entry point: characterize the fleet offline, draw a scenario's
jobs, run the event-heap simulator with ``SynergAI`` scored by the CUDA
kernels (``--v2`` for the fused batched/streaming kernel, ``--resident`` for
the device-resident tick), and print the run's summary as JSON.
``--regions K`` tags the fleet with K regions, draws per-region traffic
(``regional_scenario``) and schedules it with ``HierarchicalSynergAI``.

``--policy`` swaps in one of the paper's comparison policies (SLO-MAEL or
the five baselines), which run on the host and launch no kernel.
``--degrade FACTOR FRACTION`` silently slows ``FRACTION`` of the edge pools
``FACTOR``-fold from a third of the way in (``synth_degradations``), and
``--recharacterize online`` closes the loop with an
``OnlineRecharacterizer``; ``oracle`` installs the true factors at t = 0.

    PYTHONPATH=src python -m repro_torch.launch.schedule [--jobs 10000]
        [--pools 8 28 28] [--serving batched --streaming 2.0 2.5]
        [--v2 | --resident] [--regions K] [--device cpu]
        [--policy {synergai,slo-mael,rr,srr,lru,mru,be}]
        [--kind drift --degrade 5.0 0.35 --recharacterize online]

Without ``--device cpu`` it needs a Hopper card.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch._device import resolve_device
from repro_torch.core.baselines import (BestEffort, LeastRecentlyUsed,
                                        MostRecentlyUsed, RoundRobin,
                                        StrictRoundRobin)
from repro_torch.core.hierarchy import HierarchicalSynergAI
from repro_torch.core.metrics import summarize
from repro_torch.core.offline import characterize
from repro_torch.core.recharacterize import OnlineRecharacterizer
from repro_torch.core.scheduler import SynergAI
from repro_torch.core.scoring import make_torch_score_fn
from repro_torch.core.simulator import Cluster, Simulator
from repro_torch.core.slo_mael import SloMael
from repro_torch.core.workers import synth_fleet
from repro_torch.core.workload import (SCENARIOS, regional_scenario,
                                       scenario, synth_degradations)

# the policies that run on the host: no kernel, no score_fn
HOST_POLICIES = {"slo-mael": SloMael, "rr": RoundRobin,
                 "srr": StrictRoundRobin, "lru": LeastRecentlyUsed,
                 "mru": MostRecentlyUsed, "be": BestEffort}


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
    p.add_argument("--policy", choices=("synergai",) + tuple(HOST_POLICIES),
                   default="synergai",
                   help="the placement policy; all but synergai run on the "
                        "host and launch no kernel")
    p.add_argument("--recharacterize", choices=("off", "online", "oracle"),
                   default="off",
                   help="online: an OnlineRecharacterizer closes the "
                        "offline/online loop; oracle: the --degrade "
                        "factors installed at t = 0, detection off")
    p.add_argument("--degrade", type=float, nargs=2, default=None,
                   metavar=("FACTOR", "FRACTION"),
                   help="slow FRACTION of the edge pools FACTOR-fold "
                        "(synth_degradations)")
    p.add_argument("--device", default=None,
                   help="'cpu' runs the kernels' plain PyTorch versions; "
                        "default: the CUDA card")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    host = args.policy in HOST_POLICIES
    if host and (args.v2 or args.resident):
        p.error(f"--policy {args.policy} runs on the host: it takes no "
                "--v2 or --resident")
    if host and args.regions is not None:
        p.error("--regions schedules with HierarchicalSynergAI: "
                "--policy synergai only")
    if args.recharacterize != "off" and args.policy not in ("synergai",
                                                           "slo-mael"):
        p.error(f"--policy {args.policy} takes no re-characterizer")
    if args.recharacterize == "oracle" and args.degrade is None:
        p.error("--recharacterize oracle installs the --degrade factors: "
                "give --degrade")
    return args


def caches_of(policy) -> list:
    """The score caches of a flat or hierarchical policy (none for the
    host policies and the v1 backend)."""
    subs = getattr(policy, "_subs", None)
    pols = list(subs.values()) if subs is not None else [policy]
    return [c for c in (getattr(p, "cache", None) for p in pols)
            if c is not None]


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    host = args.policy in HOST_POLICIES
    cd = characterize()
    fleet = synth_fleet(*args.pools, regions=args.regions or 0)
    draw = scenario if args.regions is None else regional_scenario
    jobs = draw(cd, args.kind, n_jobs=args.jobs, fleet=fleet, seed=args.seed,
                serving=args.serving,
                streaming=tuple(args.streaming) if args.streaming else None)
    degradations = []
    if args.degrade is not None:
        factor, fraction = args.degrade
        degradations = synth_degradations(
            fleet, jobs[-1].arrival, factor=factor, fraction=fraction,
            prefix="edge", seed=args.seed)
    rc = None
    if args.recharacterize == "online":
        rc = OnlineRecharacterizer()
    elif args.recharacterize == "oracle":
        rc = OnlineRecharacterizer(detect=False)
        rc.seed(Cluster(cd, fleet),
                worker_factors={d.worker: d.factor for d in degradations})
    if host:
        cls = HOST_POLICIES[args.policy]
        policy = cls(recharacterizer=rc) if cls is SloMael else cls()
    else:
        score_fn = make_torch_score_fn(v2=args.v2, device=device,
                                       device_cache=args.resident)
        policy = (SynergAI if args.regions is None
                  else HierarchicalSynergAI)(score_fn=score_fn,
                                             recharacterizer=rc)
    sim = Simulator(cd, policy, fleet=fleet, seed=args.seed,
                    serving=args.serving, degradations=degradations)
    t0 = time.perf_counter()
    results = sim.run(jobs)
    stats = summarize(results)
    stats["wall_s"] = time.perf_counter() - t0
    stats["policy"] = policy.name
    stats["device"] = "host" if host else str(score_fn.device)
    stats["refreshes"] = rc.refreshes if rc is not None else 0
    stats["profile_reclaims"] = sum(c.profile_reclaims
                                    for c in caches_of(policy))
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
