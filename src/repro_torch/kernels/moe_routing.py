"""MoE top-k routing on a hand-written CUDA kernel: router logits, softmax,
the top-k mask and the renormalized gates.

The counterpart of ``repro/kernels/moe_routing.py`` (and of
``kernels/ref.py:moe_routing_ref``), with the top-k semantics of the JAX
model's ``_route_grouped``: for each token, in f32,

    probs = softmax(x @ W);  k first-index argmax rounds over probs
    gates = probs at the k picks / max(their sum, 1e-9), zeros elsewhere
    mask  = 1 at the k picks

A pick is made whatever its probability, as ``lax.top_k`` makes it; the
Pallas kernel skips probabilities <= 0, which differs only where a top-k
probability underflows to 0.  ``moe_routing`` returns the mask beside the
gates because the model's dispatch consumes it.

``moe_routing`` takes its plain PyTorch version (``moe_routing_plain``) for
tensors on the CPU and launches ``csrc/moe_routing.cu`` for tensors on the
card; there is no other path.  The kernel has two designs: for T below
``SWITCH_T`` a cluster of 8 CTAs for every 8 tokens, the chains of each
(token, expert) spread over the cluster (decode), and from ``SWITCH_T`` on
32 tokens a CTA, register-blocked (prefill); ``design`` forces one of them.
``moe_routing.launches`` counts kernel launches.  Unlike the Pallas wrapper
it takes any T (T = 0 returns empty outputs with no launch), any D,
E <= 256 and 1 <= top_k <= E.  The kernel has no backward yet (the MoE/MLA
training slice: the gates carry the router's gradient): on the card it
refuses to run when grad mode is on and an input requires grad
(``_build.refuse_grad``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

MAX_EXPERTS = 256
LANES = 32           # the kernel's warp: lane l sums d = l, l + 32, ...
PLAIN_CHUNK = 1024   # tokens per pass of the plain version (memory)
SWITCH_T = 1280      # the kernel's decode design below, prefill from here
DESIGNS = {None: -1, "decode": 0, "prefill": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]


def check_routing_inputs(x, router_w, top_k):
    """Validate the arguments of ``moe_routing`` (on the CPU as on the
    card); returns (T, D, E)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("moe_routing: x must be a 2-D [T, D] tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"moe_routing: x has dtype {x.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if (not isinstance(router_w, torch.Tensor) or router_w.dim() != 2
            or router_w.dtype != torch.float32):
        raise ValueError("moe_routing: router_w must be a 2-D float32 "
                         "[D, E] tensor")
    T, D = x.shape
    if router_w.shape[0] != D:
        raise ValueError(f"moe_routing: router_w {tuple(router_w.shape)} "
                         f"does not take x of width {D}")
    E = router_w.shape[1]
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"moe_routing: {E} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if not 1 <= int(top_k) <= E:
        raise ValueError(f"moe_routing: top_k {top_k} outside 1..{E}")
    if x.device != router_w.device:
        raise ValueError(f"moe_routing: x on {x.device}, router_w on "
                         f"{router_w.device}")
    if not (x.is_contiguous() and router_w.is_contiguous()):
        raise ValueError("moe_routing: x and router_w must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"moe_routing runs on cpu or cuda, not {x.device}")
    return T, D, E


def _lane_tree(p):
    """Sum ``p`` [T, 32, E] over its lane axis as the kernel's xor-shuffle
    tree does: lane i with lane i + 16, then the same over the halves."""
    while p.shape[1] > 1:
        half = p.shape[1] // 2
        p = p[:, :half] + p[:, half:]
    return p[:, 0]


def _in_order(p):
    """Sum ``p`` [T, E] over experts one by one in index order, from 0."""
    s = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    for e in range(p.shape[1]):
        s = s + p[:, e]
    return s


def _route_rows(xf, w, top_k):
    T, D = xf.shape
    E = w.shape[1]
    # the logits: lane l's partial sums d = l, l + 32, ... in increasing d,
    # each product rounded, then added; then the lane tree
    acc = torch.zeros((T, LANES, E), dtype=torch.float32, device=xf.device)
    for d0 in range(0, D, LANES):
        n = min(LANES, D - d0)
        prod = xf[:, d0:d0 + n, None] * w[None, d0:d0 + n, :]
        acc[:, :n] = acc[:, :n] + prod
    logits = _lane_tree(acc)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = p / _in_order(p)[:, None]
    remaining = probs.clone()
    mask = torch.zeros_like(probs)
    rows = torch.arange(T, device=xf.device)
    for _ in range(int(top_k)):
        pick = remaining.argmax(dim=-1)       # the first maximum
        mask[rows, pick] = 1.0
        remaining[rows, pick] = -1.0
    sel = probs * mask
    gates = sel / torch.clamp(_in_order(sel), min=1e-9)[:, None]
    return gates, mask


def moe_routing_plain(x, router_w, top_k):
    """The plain PyTorch version of ``moe_routing``: the same f32 math,
    rounded as the kernel rounds it (each product and sum once, the sum over
    d as 32 lane sums in increasing d and a fixed pairwise tree over the
    lanes, the softmax and gate sums in expert-index order), so that kernel
    and plain version agree bit for bit; over ``PLAIN_CHUNK`` tokens at a
    time."""
    T, _ = x.shape
    E = router_w.shape[1]
    gates = torch.empty((T, E), dtype=torch.float32, device=x.device)
    mask = torch.empty_like(gates)
    for t0 in range(0, T, PLAIN_CHUNK):
        t1 = min(T, t0 + PLAIN_CHUNK)
        gates[t0:t1], mask[t0:t1] = _route_rows(x[t0:t1].float(), router_w,
                                                top_k)
    return gates, mask


def moe_routing(x, router_w, top_k, design=None):
    """x: [T, D] float32 or bfloat16 (cast to f32 inside); router_w: [D, E]
    float32; contiguous, on one device.  Returns (gates [T, E] f32, zeros
    off the top-k and renormalized over it; mask [T, E] f32, 1 at the
    top-k).  ``design`` ("decode" or "prefill") overrides the kernel's
    choice by T; both give the same bits."""
    T, D, E = check_routing_inputs(x, router_w, top_k)
    _build.refuse_grad("moe_routing", "the MoE/MLA training slice (a router "
                       "backward: the gates carry the router's gradient)",
                       x, router_w)
    if design not in DESIGNS:
        raise ValueError(f"moe_routing: design {design!r} is none of "
                         f"{sorted(k for k in DESIGNS if k)}")
    if x.device.type == "cpu":
        return moe_routing_plain(x, router_w, top_k)
    gates = torch.empty((T, E), dtype=torch.float32, device=x.device)
    mask = torch.empty_like(gates)
    if T == 0:               # no token: empty outputs, no launch
        return gates, mask
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch("moe_routing", "synergai_moe_routing_design",
                      _ARGTYPES, "synergai_moe_error_string",
                      x.data_ptr(), router_w.data_ptr(), gates.data_ptr(),
                      mask.data_ptr(), DTYPES[x.dtype], T, D, E, int(top_k),
                      DESIGNS[design], stream)
    moe_routing.launches += 1
    return gates, mask


moe_routing.launches = 0
