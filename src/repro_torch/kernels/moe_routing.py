"""MoE top-k routing on a hand-written CUDA kernel: router logits, softmax,
the top-k mask and the renormalized gates; and its gradient, on a second.

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
Unlike the Pallas wrapper it takes any T (T = 0 returns empty outputs with
no launch), any D, E <= 256 and 1 <= top_k <= E.

Its gradient is ``MoeRoutingFn``, taken whenever grad mode is on and an
input requires grad: the forward above, saving x and W; the backward is
``moe_routing_bwd``, which launches ``csrc/moe_routing_bwd.cu`` on card
tensors and runs ``moe_routing_bwd_plain`` on CPU tensors.  The mask carries
no gradient (a one-hot of integer picks, as in JAX); the gates carry the
router's.  The JAX package has no kernel for it: its training takes
``jax.value_and_grad`` of ``_route_grouped``.  ``moe_routing.launches`` and
``moe_routing_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import _build, _local
from repro_torch.kernels.flash_attention import DTYPES, _wants_grad

MAX_EXPERTS = 256
LANES = 32           # the kernel's warp: lane l sums d = l, l + 32, ...
PLAIN_CHUNK = 1024   # tokens per pass of the plain version (memory)
SWITCH_T = 1280      # the kernel's decode design below, prefill from here
DW_CHUNK = 512       # tokens a partial of the backward's dW (kChunk)
DESIGNS = {None: -1, "decode": 0, "prefill": 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]
_BWD_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]


def check_routing_inputs(x, router_w, top_k, what="moe_routing"):
    """Validate the arguments of ``moe_routing`` (on the CPU as on the
    card); returns (T, D, E)."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{what}: x must be a 2-D [T, D] tensor")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: x has dtype {x.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if (not isinstance(router_w, torch.Tensor) or router_w.dim() != 2
            or router_w.dtype != torch.float32):
        raise ValueError(f"{what}: router_w must be a 2-D float32 [D, E] "
                         "tensor")
    T, D = x.shape
    if router_w.shape[0] != D:
        raise ValueError(f"{what}: router_w {tuple(router_w.shape)} "
                         f"does not take x of width {D}")
    E = router_w.shape[1]
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{what}: {E} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if not 1 <= int(top_k) <= E:
        raise ValueError(f"{what}: top_k {top_k} outside 1..{E}")
    if x.device != router_w.device:
        raise ValueError(f"{what}: x on {x.device}, router_w on "
                         f"{router_w.device}")
    if not (x.is_contiguous() and router_w.is_contiguous()):
        raise ValueError(f"{what}: x and router_w must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
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


def _probs(xf, w):
    """The softmax of the router logits of ``xf`` [T, D] f32, rounded as
    the kernels round it."""
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
    return p / _in_order(p)[:, None]


def _picks(probs, top_k):
    """The top-k mask of ``probs``: k first-index argmax rounds."""
    remaining = probs.clone()
    mask = torch.zeros_like(probs)
    rows = torch.arange(probs.shape[0], device=probs.device)
    for _ in range(int(top_k)):
        pick = remaining.argmax(dim=-1)       # the first maximum
        mask[rows, pick] = 1.0
        remaining[rows, pick] = -1.0
    return mask


def _route_rows(xf, w, top_k):
    probs = _probs(xf, w)
    mask = _picks(probs, top_k)
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


def _launch(x, router_w, top_k, design):
    """The forward kernel on card tensors: (gates, mask)."""
    T, D = x.shape
    E = router_w.shape[1]
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


def _route(x, router_w, top_k, design):
    if x.device.type == "cpu":
        return moe_routing_plain(x, router_w, top_k)
    return _launch(x, router_w, top_k, design)


class MoeRoutingFn(torch.autograd.Function):
    """``moe_routing`` with its gradient.  Forward: the kernel (the plain
    version on CPU tensors), the same bits as without a gradient; it saves x
    and W, and the backward recomputes the probabilities from them.
    Backward: ``moe_routing_bwd`` on the gates' cotangent; the mask gets
    none."""

    @staticmethod
    def forward(ctx, x, router_w, top_k, design):
        gates, mask = _route(x, router_w, top_k, design)
        ctx.save_for_backward(x, router_w)
        ctx.top_k = top_k
        ctx.mark_non_differentiable(mask)
        return gates, mask

    @staticmethod
    def backward(ctx, dgates, _dmask):
        x, router_w = ctx.saved_tensors
        dx, dw = moe_routing_bwd(x, router_w, ctx.top_k,
                                 dgates.float().contiguous())
        return dx, dw, None, None


def moe_routing(x, router_w, top_k, design=None):
    """x: [T, D] float32 or bfloat16 (cast to f32 inside); router_w: [D, E]
    float32; contiguous, on one device.  Returns (gates [T, E] f32, zeros
    off the top-k and renormalized over it; mask [T, E] f32, 1 at the
    top-k), through ``MoeRoutingFn`` when grad mode is on and an input
    requires grad.  ``design`` ("decode" or "prefill") overrides the
    kernel's choice by T; both give the same bits.  On DTensors the same
    call runs on the local shards: x's token shards (dim 0) kept where they
    divide, D and E whole."""
    if isinstance(x, DTensor):
        pl = _local.kept(x, {0: x.shape[0]})
        whole = [Replicate()] * x.device_mesh.ndim
        return _local.call(lambda x, w: _moe_routing(x, w, top_k, design),
                           (x, router_w), (pl, whole), (pl, pl),
                           (pl, _local.summed_over(pl, 0, whole)))
    return _moe_routing(x, router_w, top_k, design)


def _moe_routing(x, router_w, top_k, design):
    check_routing_inputs(x, router_w, top_k)
    if design not in DESIGNS:
        raise ValueError(f"moe_routing: design {design!r} is none of "
                         f"{sorted(k for k in DESIGNS if k)}")
    if _wants_grad(x, router_w):
        return MoeRoutingFn.apply(x, router_w, int(top_k), design)
    return _route(x, router_w, top_k, design)


moe_routing.launches = 0


# ----------------------------------------------------------------------------
# the backward


def _dlogits_rows(xf, w, top_k, dg):
    """The logits' gradient [T, E] of the tokens ``xf`` [T, D] f32, given
    the gates' cotangent ``dg``: the forward's probs and picks, then
        c1 = sum_e dg gates,  dprobs = mask (dg - c1) / den,
        c2 = sum_e dprobs probs,  dlogits = probs (dprobs - c2),
    the sums in expert order, as the kernel rounds them."""
    probs = _probs(xf, w)
    mask = _picks(probs, top_k)
    sel = probs * mask
    den = torch.clamp(_in_order(sel), min=1e-9)[:, None]
    c1 = _in_order(dg * (sel / den))[:, None]
    dprobs = torch.where(mask > 0, (dg - c1) / den, 0.0)
    c2 = _in_order(dprobs * probs)[:, None]
    return probs * (dprobs - c2)


def _dx_rows(dlogits, w):
    """dx [T, D] f32 = dlogits W^T, each element summed over the experts
    one by one in index order, from 0."""
    acc = torch.zeros((dlogits.shape[0], w.shape[0]), dtype=torch.float32,
                      device=w.device)
    for e in range(w.shape[1]):
        acc = acc + dlogits[:, e, None] * w[None, :, e]
    return acc


def _dw(xf, dlogits):
    """dW [D, E] f32 = xf^T dlogits as the kernel sums it: over each chunk
    of ``DW_CHUNK`` tokens in increasing t, from 0, then the chunks' sums
    in chunk order, from 0 (a ragged last chunk padded with zero tokens,
    whose +-0 products change no sum)."""
    T, D = xf.shape
    E = dlogits.shape[1]
    C = min(DW_CHUNK, T)
    n = -(-T // C)
    pad = n * C - T
    xc = torch.nn.functional.pad(xf, (0, 0, 0, pad)).view(n, C, D)
    dc = torch.nn.functional.pad(dlogits, (0, 0, 0, pad)).view(n, C, E)
    acc = torch.zeros((n, D, E), dtype=torch.float32, device=xf.device)
    for j in range(C):
        acc = acc + xc[:, j, :, None] * dc[:, j, None, :]
    dw = torch.zeros((D, E), dtype=torch.float32, device=xf.device)
    for c in range(n):
        dw = dw + acc[c]
    return dw


def moe_routing_bwd_plain(x, router_w, top_k, dgates):
    """The plain PyTorch version of ``moe_routing_bwd``: the same f32 math
    in the kernel's order (the forward's logits, probs and picks; dlogits
    and dx summed over the experts in index order; dW over the tokens in
    chunks of ``DW_CHUNK``, then over the chunks), so that kernel and plain
    version agree bit for bit; dx and dlogits over ``PLAIN_CHUNK`` tokens at
    a time.  Returns (dx in x's dtype, dW f32)."""
    T, D = x.shape
    E = router_w.shape[1]
    dx = torch.empty_like(x)
    if T == 0:
        return dx, torch.zeros((D, E), dtype=torch.float32, device=x.device)
    dlogits = torch.empty((T, E), dtype=torch.float32, device=x.device)
    for t0 in range(0, T, PLAIN_CHUNK):
        t1 = min(T, t0 + PLAIN_CHUNK)
        dlogits[t0:t1] = _dlogits_rows(x[t0:t1].float(), router_w, top_k,
                                       dgates[t0:t1])
        dx[t0:t1] = _dx_rows(dlogits[t0:t1], router_w).to(x.dtype)
    return dx, _dw(x.float(), dlogits)


def moe_routing_bwd(x, router_w, top_k, dgates):
    """The gradient of ``moe_routing``'s gates with respect to x and
    router_w, given the gates' cotangent ``dgates`` [T, E] float32: (dx
    [T, D] in x's dtype, rounded once from f32; dW [D, E] f32).  The picks
    are the forward's, recomputed from x and W.  Launches
    ``csrc/moe_routing_bwd.cu`` (its token kernel, its dW kernel and, where
    T > ``DW_CHUNK``, the merge of the chunks' partials) on card tensors,
    runs ``moe_routing_bwd_plain`` on CPU tensors."""
    T, D, E = check_routing_inputs(x, router_w, top_k, "moe_routing_bwd")
    if (not isinstance(dgates, torch.Tensor) or dgates.shape != (T, E)
            or dgates.dtype != torch.float32 or dgates.device != x.device
            or not dgates.is_contiguous()):
        raise ValueError(f"moe_routing_bwd: dgates must be a contiguous "
                         f"float32 [{T}, {E}] tensor on x's device")
    if x.device.type == "cpu":
        return moe_routing_bwd_plain(x, router_w, top_k, dgates)
    dx = torch.empty_like(x)
    if T == 0:               # no token: no launch
        return dx, torch.zeros((D, E), dtype=torch.float32, device=x.device)
    dw = torch.empty((D, E), dtype=torch.float32, device=x.device)
    dlogits = torch.empty((T, E), dtype=torch.float32, device=x.device)
    n_chunks = -(-T // DW_CHUNK)
    partial = (torch.empty((n_chunks, D, E), dtype=torch.float32,
                           device=x.device) if n_chunks > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.launch("moe_routing_bwd", "synergai_moe_routing_bwd",
                      _BWD_ARGTYPES, "synergai_moe_bwd_error_string",
                      x.data_ptr(), router_w.data_ptr(), dgates.data_ptr(),
                      dx.data_ptr(), dw.data_ptr(), dlogits.data_ptr(),
                      partial.data_ptr() if partial is not None else None,
                      DTYPES[x.dtype], T, D, E, int(top_k), stream)
    moe_routing_bwd.launches += 1
    return dx, dw


moe_routing_bwd.launches = 0
