#!/usr/bin/env python3
"""Time the port's redesigned kernels of one or more checkouts on the card.

    python3 tools/time_kernels.py ROOT [ROOT ...]

For each checkout ROOT (the root of a checkout of this repository, with
``chip_smoke.py`` and ``src/repro_torch`` in it), in a process of its own,
each kernel is held to its plain version and timed on the card: the
profiler's device ms of one call, averaged over 25.

- the router (``moe_routing``, x in bf16, bit for bit) at [T, D, E, k] =
  [4, 4096, 16, 2], [1, 4096, 16, 2], [4096, 4096, 16, 2],
  [1000, 4000, 16, 2] and [4096, 5120, 160, 6];
- ``tick_score`` (exactly) at (J, cap, W) = (22, 506, 64),
  (2043, 4096, 256), (10000, 16384, 64) and (16384, 32768, 2048), energy
  off and on;
- ``decode_attention`` (within ``chip_smoke.ATTN_TOL``, bf16 and f32) at
  [B, S, H, K, hd, k_valid] = the serving buffer [4, 1064, 32, 8, 128] at
  k_valid 1, 1025, 1064 and 1040 (the serving path's mean step), a ragged
  hd-80 buffer, hd-256 MQA, G = 5 and k_valid 1024, and the rest of the
  checkout's ``chip_smoke.DECODE_HOLDS``; each output's sha256 (its first
  16 hex digits) beside its time, so that two checkouts' outputs can be
  compared bit for bit;
- ``rwkv_scan`` (bit for bit, f32 and bf16) at [B, S, H, hd] =
  [4, 1024, 32, 64] from zeros, [4, 1, 32, 64], [2, 1000, 8, 64],
  [2, 333, 8, 16] and [1, 515, 2, 64] from a random state;
- ``flash_attention`` (within ``chip_smoke.ATTN_TOL``, bf16 and f32) at
  the checkout's ``chip_smoke.FLASH_HOLDS``, as serving calls it (no
  log-sum-exp), and, where the checkout's forward can write one, with its
  log-sum-exp as a training step calls it (``lse`` keys);
- ``flash_attention_bwd`` (within ``chip_smoke.BWD_REL`` of max |plain|,
  bf16 and f32) at the checkout's ``chip_smoke.FLASH_BWD_HOLDS``, fed the
  checkout's forward output and log-sum-exp (``bwd`` keys);
- ``rwkv_scan_bwd`` (bit for bit, all five outputs) at the checkout's
  ``chip_smoke.RWKV_BWD_HOLDS``, fed the checkout's forward chunk states
  (``wkv_bwd`` keys);
- ``moe_routing_bwd`` (dx and dW bit for bit, x in bf16 and f32) at the
  checkout's ``chip_smoke.ROUTING_BWD_HOLDS``, each of its kernels' device
  ms beside the sum (``router_bwd`` keys).

``--only`` takes a comma-separated list of those groups (router, tick,
decode, wkv, flash, bwd, wkv_bwd, router_bwd) and times only them.  One
JSON line per checkout, with the card's name and power limit.  To compare
two commits, unpack the parent into a directory that .gitignore lists and
give both in turns, parent first and last:
``python3 tools/time_kernels.py build/parent . . build/parent``.
"""

import hashlib
import json
import subprocess
import sys

import numpy as np

ROUTER = ((4, 4096, 16, 2), (1, 4096, 16, 2), (4096, 4096, 16, 2),
          (1000, 4000, 16, 2), (4096, 5120, 160, 6))
TICK = ((22, 506, 64), (2043, 4096, 256), (10000, 16384, 64),
        (16384, 32768, 2048))
DECODE = ((4, 1064, 32, 8, 128, 1), (4, 1064, 32, 8, 128, 1025),
          (4, 1064, 32, 8, 128, 1064), (4, 1000, 32, 8, 80, 777),
          (2, 2056, 8, 1, 256, 2050), (4, 1064, 32, 8, 128, 1040),
          (2, 1000, 25, 5, 64, 999), (4, 1064, 32, 8, 128, 1024))
WKV = ((4, 1024, 32, 64, False), (4, 1, 32, 64, True),
       (2, 1000, 8, 64, True), (2, 333, 8, 16, True),
       (1, 515, 2, 64, True))


GROUPS = ("router", "tick", "decode", "wkv", "flash", "bwd", "wkv_bwd",
          "router_bwd")


def time_checkout(root, only=GROUPS):
    sys.path[:0] = [root, root + "/src"]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_routing as mr
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.kernels import scheduler_score as ss
    torch.backends.cuda.matmul.allow_tf32 = False

    def pick(group, items):
        return items if group in only else ()

    out = {"checkout": root, "card": cs.card_line()}
    for T, D, E, k in pick("router", ROUTER):
        x, w = cs.routing_inputs(T, D, E, torch.bfloat16, T + D + E)
        got, want = mr.moe_routing(x, w, k), mr.moe_routing_plain(x, w, k)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{root}: router {(T, D, E, k)} differs")
        out[f"router {T},{D},{E},{k}"] = cs.device_ms(
            lambda: mr.moe_routing(x, w, k), "moe_routing_kernel")
    for J, cap, W in pick("tick", TICK):
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
    decode = DECODE + tuple(s for s in cs.DECODE_HOLDS if s not in DECODE)
    for B, S, H, K, hd, k_valid in pick("decode", decode):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = cs.attn_inputs((B, 1, H, hd), (B, S, K, hd), dtype,
                                     S + hd)
            raw = da.decode_attention(q, k, v, k_valid)
            out[f"decode {B},{S},{H},{K},{hd},{k_valid} {dtype} sha256"] = (
                hashlib.sha256(raw.view(torch.uint8).cpu().numpy()
                               .tobytes()).hexdigest()[:16])
            got = raw.float()
            want = da.decode_attention_plain(q, k, v, k_valid).float()
            rtol, atol = cs.ATTN_TOL[str(dtype).split(".")[1]]
            if not bool(((got - want).abs() <= atol + rtol * want.abs())
                        .all()):
                raise SystemExit(f"{root}: decode {(B, S, H, K, hd, k_valid)}"
                                 f" {dtype} outside ATTN_TOL")
            out[f"decode {B},{S},{H},{K},{hd},{k_valid} {dtype}"] = (
                cs.device_ms(lambda: da.decode_attention(q, k, v, k_valid),
                             "decode_attention_"))
    for B, S, H, hd, with_state in pick("wkv", WKV):
        for dtype in (torch.float32, torch.bfloat16):
            ins, state = cs.rwkv_inputs(B, S, H, hd, dtype, S + hd,
                                        with_state)
            y, s = rs.rwkv_scan(*ins, state)
            y_plain, s_plain = rs.rwkv_scan_plain(*ins, state)
            torch.cuda.synchronize()
            if not (torch.equal(y, y_plain) and torch.equal(s, s_plain)):
                raise SystemExit(f"{root}: wkv {(B, S, H, hd)} {dtype} is "
                                 "not bit-equal")
            out[f"wkv {B},{S},{H},{hd} {dtype}"] = cs.device_ms(
                lambda: rs.rwkv_scan(*ins, state), "rwkv_scan_kernel")
    for B, S, H, K, hd, window, causal in pick("flash", cs.FLASH_HOLDS):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = cs.attn_inputs((B, S, H, hd), (B, S, K, hd), dtype,
                                     S + hd)

            def flash():
                return fa.flash_attention(q, k, v, causal=causal,
                                          window=window)

            got = flash().float()
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window).float()
            rtol, atol = cs.ATTN_TOL[str(dtype).split(".")[1]]
            if not bool(((got - want).abs() <= atol + rtol * want.abs())
                        .all()):
                raise SystemExit(f"{root}: flash {(B, S, H, K, hd)} {dtype}"
                                 " outside ATTN_TOL")
            key = f"flash {B},{S},{H},{K},{hd},{window},{int(causal)} {dtype}"
            out[key] = cs.device_ms(flash, "flash_attention_kernel")
            if hasattr(fa, "_launch_forward"):
                out[key + " lse"] = cs.device_ms(
                    lambda: fa._launch_forward(q, k, v, causal, window, True),
                    "flash_attention_kernel")
    for B, S, H, K, hd, window, causal in pick(
            "bwd", getattr(cs, "FLASH_BWD_HOLDS", ())):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = cs.attn_inputs((B, S, H, hd), (B, S, K, hd), dtype,
                                     S + hd)
            dout = torch.randn(q.shape, generator=torch.Generator(
                device="cuda").manual_seed(S), device="cuda", dtype=dtype)
            o, lse = fa._launch_forward(q, k, v, causal, window, True)

            def bwd():
                return fa.flash_attention_bwd(q, k, v, o, lse, dout,
                                              causal=causal, window=window)

            name = str(dtype).split(".")[1]
            for a, b in zip(bwd(), fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, dout, causal=causal, window=window)):
                if float((a.float() - b.float()).abs().max()) > (
                        cs.BWD_REL[name] * float(b.float().abs().max())):
                    raise SystemExit(f"{root}: flash backward "
                                     f"{(B, S, H, K, hd)} {dtype} outside "
                                     "BWD_REL")
            key = (f"bwd {B},{S},{H},{K},{hd},{window},{int(causal)} "
                   f"{dtype}")
            out[key] = cs.device_ms(bwd, "flash_attention_bwd_", reps=5)
            del q, k, v, dout, o, lse
            torch.cuda.empty_cache()
    for B, S, H, hd, with_state in pick(
            "wkv_bwd", getattr(cs, "RWKV_BWD_HOLDS", ())):
        ins, state = cs.rwkv_inputs(B, S, H, hd, torch.float32, S + hd + 7,
                                    with_state)
        rng = np.random.default_rng(S + hd + 8)
        dy = torch.from_numpy(rng.standard_normal(
            (B, S, H, hd), dtype=np.float32)).cuda()
        ds = (torch.from_numpy(rng.standard_normal(
            (B, H, hd, hd), dtype=np.float32)).cuda() if with_state else None)
        ckpt = torch.empty((B, H, rs.n_chunks(S), hd, hd), device="cuda")
        rs._scan(*ins, state, None, ckpt)
        args = (*ins[:4], ckpt, dy, ds)
        got = rs.rwkv_scan_bwd(*args)
        torch.cuda.synchronize()
        if not all(cs.exact(a, b)
                   for a, b in zip(got, rs.rwkv_scan_bwd_plain(*args))):
            raise SystemExit(f"{root}: wkv backward {(B, S, H, hd)} is not "
                             "bit-equal")
        out[f"wkv_bwd {B},{S},{H},{hd}"] = cs.device_ms(
            lambda: rs.rwkv_scan_bwd(*args), "rwkv_scan_bwd_kernel", reps=5)
        del got, args, ckpt, dy, ds, ins
        torch.cuda.empty_cache()
    for T, D, E, k, case in pick(
            "router_bwd", getattr(cs, "ROUTING_BWD_HOLDS", ())):
        for dtype in (torch.bfloat16, torch.float32):
            x, w, dg = cs.routing_bwd_inputs(T, D, E, dtype, T + D + E, case)
            got = mr.moe_routing_bwd(x, w, k, dg)
            torch.cuda.synchronize()
            if not all(cs.exact(a, b) for a, b in zip(
                    got, mr.moe_routing_bwd_plain(x, w, k, dg))):
                raise SystemExit(f"{root}: router backward {(T, D, E, k)} "
                                 f"{case} {dtype} is not bit-equal")
            by_kernel = {}
            key = f"router_bwd {T},{D},{E},{k} {case} {dtype}"
            out[key] = cs.device_ms(lambda: mr.moe_routing_bwd(x, w, k, dg),
                                    "moe_routing_bwd_", by_name=by_kernel)
            out[key + " by kernel"] = by_kernel
    print(json.dumps(out), flush=True)


def main():
    args = sys.argv[1:]
    only = GROUPS
    if args[:1] == ["--only"]:
        only, args = tuple(args[1].split(",")), args[2:]
    if len(args) == 2 and args[0] == "--one":
        time_checkout(args[1], only)
        return 0
    rc = 0
    for root in args:
        extra = ["--only", ",".join(only)] if only != GROUPS else []
        rc |= subprocess.run([sys.executable, __file__, *extra, "--one",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
