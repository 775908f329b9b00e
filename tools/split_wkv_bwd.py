#!/usr/bin/env python3
"""Split the WKV backward kernel's time on the card by copies of its source
with one part compiled out.

    python3 tools/split_wkv_bwd.py ROOT [ROOT ...]

For each checkout ROOT, ``src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu`` is
copied into ``build/split_wkv_bwd/`` (which .gitignore lists) once as it is
and once for each cut below whose text the source holds, each copy built by
``nvcc`` with the port's flags (all at once) and timed at rwkv6's training
shape [2, 4096, 32, 64] and at [2, 1000, 8, 64]: CUDA events around two
calls, the median of five.  A cut changes what the kernel computes, so the
copies' outputs are not used; what a cut saves is an upper bound on what
that part costs in the whole kernel.  The cuts match the kernel of this
tree (a cluster of CTAs a head, the partials merged through distributed
shared memory) or the first design's (one CTA a head, its chunk states in
a device-memory scratch); a cut whose text a source lacks is skipped.
One JSON line per checkout, with the card's name and power limit.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

# name: ((text, replacement), ...)
CUTS = {
    # the first design
    "recompute only": (("for (int tt = n - 1; tt >= 0; --tt) {",
                        "for (int tt = n - 1; tt >= 0 && S < 0; --tt) {"),),
    "step-back only": (("for (int tt = 0; tt < n; ++tt) {",
                        "for (int tt = 0; tt < n && S < 0; ++tt) {"),),
    "step-back only, no scratch reads": (
        ("for (int tt = 0; tt < n; ++tt) {",
         "for (int tt = 0; tt < n && S < 0; ++tt) {"),
        ("sn[c][m] = scr[static_cast<size_t>((tt - 1) * E + c * M + m) *\n"
         "                           NT];",
         "sn[c][m] = __fadd_rn(s[c][m], 1.0f);")),
    "step-back only, no barrier": (
        ("for (int tt = 0; tt < n; ++tt) {",
         "for (int tt = 0; tt < n && S < 0; ++tt) {"),
        ("      __syncthreads();\n"
         "      for (int e = tid; e < 3 * HD; e += NT) {",
         "      for (int e = tid; e < 3 * HD; e += NT) {")),
    # this tree's design
    "no first pass": (("          advance(s[0], s[1], q * kSteps + tt);\n"
                       "          advance(s[1], s[0], q * kSteps + tt + 1);\n",
                       ""),),
    "no dv shuffles": (("      dv_levels<NC, L / 2>(dvj, lane, cb);\n", ""),),
    "no cluster barrier": (("        cluster_wait();\n", ""),
                           ("      cluster_arrive();\n", "")),
    "no merge": (("        merge_sum(part + ((ng - 1) % kBufs) * P::PART, "
                  "p_n, sum);\n", ""),
                 ("  merge_sum(part + ((ng - 1) % kBufs) * P::PART, p_n, "
                  "sum);\n", ""),
                 ("      if (ng > 0) merge_store(sum, p_t0, p_n);\n", ""),
                 ("  merge_store(sum, p_t0, p_n);\n", "")),
}
SHAPES = ((2, 4096, 32, 64), (2, 1000, 8, 64))


def variants(src):
    out = {"whole": src}
    for name, subs in CUTS.items():
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                break
            text = text.replace(a, b)
        else:
            out[name] = text
    return out


def split_checkout(root, here):
    sys.path[:0] = [str(here / "src")]
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv_scan as rs
    src = (Path(root) / "src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu"
           ).read_text()
    with_split = "int hd, int split," in src   # this tree's C interface
    out_dir = here / "build" / "split_wkv_bwd" / Path(root).resolve().name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants(src).items()):
        path = out_dir / f"v{i}.cu"
        path.write_text(text)
        procs[name] = (path.with_suffix(".so"), subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{root}: nvcc failed on '{name}':\n{log}")
        fn = ctypes.CDLL(str(lib)).synergai_rwkv_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * (
            5 if with_split else 4) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"checkout": root, "card": card}
    for B, S, H, hd in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(S)
        r, k, v, dy = (torch.randn((B, S, H, hd), device="cuda", generator=g)
                       for _ in range(4))
        w = torch.rand((B, S, H, hd), device="cuda", generator=g) * 0.5 + 0.45
        u = torch.randn((H, hd), device="cuda", generator=g)
        ckpt = torch.empty((B, H, rs.n_chunks(S), hd, hd), device="cuda")
        rs._scan(r, k * 0.1, v, w, u, None, None, ckpt)
        outs = [torch.empty_like(r) for _ in range(4)]
        ds0 = torch.empty((B, H, hd, hd), device="cuda")
        # room for either design's scratch (the first one's is the larger)
        scratch = torch.zeros((B * H, rs.CHUNK, hd, hd), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        tail = (B, S, H, hd) + ((rs.bwd_split(B, H, hd),) if with_split
                                else ())
        for name, fn in fns.items():
            def call():
                rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        w.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), None,
                        *(o.data_ptr() for o in outs), ds0.data_ptr(),
                        scratch.data_ptr(), *tail, stream)
                if rc:
                    raise SystemExit(f"{root}: '{name}' launch failed: {rc}")
            call()
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                call()
                call()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / 2)
            result[f"{B},{S},{H},{hd} {name}"] = statistics.median(times)
    print(json.dumps(result), flush=True)


def main():
    here = Path(__file__).resolve().parents[1]
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        split_checkout(sys.argv[2], here)
        return 0
    rc = 0
    for root in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one",
                              root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
