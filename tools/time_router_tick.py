#!/usr/bin/env python3
"""Time the port's router and tick score kernels of one checkout on the card.

    python3 tools/time_router_tick.py ROOT [ROOT ...]

For each checkout ROOT (the root of a checkout of this repository, with
``chip_smoke.py`` and ``src/repro_torch`` in it), in a process of its own,
the router (``moe_routing``, x in bf16) at [T, D, E, k] = [4, 4096, 16, 2],
[1, 4096, 16, 2], [4096, 4096, 16, 2], [1000, 4000, 16, 2] and
[4096, 5120, 160, 6], and ``tick_score`` at (J, cap, W) = (22, 506, 64),
(2043, 4096, 256), (10000, 16384, 64) and (16384, 32768, 2048), energy off
and on, are held to their plain versions (bit for bit) and timed on the
card: the profiler's device ms of one call, averaged over 25.  One JSON line
per checkout.  To compare two commits, unpack the parent into a directory
that .gitignore lists and give both, parent first and last:
``python3 tools/time_router_tick.py build/parent . . build/parent``.
"""

import json
import subprocess
import sys

ROUTER = ((4, 4096, 16, 2), (1, 4096, 16, 2), (4096, 4096, 16, 2),
          (1000, 4000, 16, 2), (4096, 5120, 160, 6))
TICK = ((22, 506, 64), (2043, 4096, 256), (10000, 16384, 64),
        (16384, 32768, 2048))


def time_checkout(root):
    sys.path[:0] = [root, root + "/src"]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import scheduler_score as ss
    out = {"checkout": root, "card": cs.card_line()}
    for T, D, E, k in ROUTER:
        x, w = cs.routing_inputs(T, D, E, torch.bfloat16, T + D + E)
        got, want = mr.moe_routing(x, w, k), mr.moe_routing_plain(x, w, k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{root}: router {(T, D, E, k)} differs")
        out[f"router {T},{D},{E},{k}"] = cs.device_ms(
            lambda: mr.moe_routing(x, w, k), "moe_routing_kernel")
    for J, cap, W in TICK:
        for energy in (False, True):
            inputs = cs.to_card(cs.messy_tick_inputs(J, cap, W, seed=J + W,
                                                     deep=energy))

            def score():
                return ss.tick_score(*inputs[:17], use_energy=energy)

            got = score()
            want = ss.tick_score_plain(*inputs[:17], use_energy=energy)
            torch.cuda.synchronize()
            if not all(cs.exact(a, b) for a, b in zip(got, want)):
                raise SystemExit(f"{root}: tick {(J, cap, W)} differs")
            out[f"tick {J},{cap},{W} energy {int(energy)}"] = cs.device_ms(
                score, "tick_score_kernel")
            del inputs
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        time_checkout(sys.argv[2])
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
