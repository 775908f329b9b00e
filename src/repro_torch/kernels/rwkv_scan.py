"""The RWKV6 WKV recurrence on a hand-written CUDA kernel, carrying the
state in and out, and its backward on another.

The counterpart of ``repro/kernels/rwkv_scan.py`` (and of
``kernels/ref.py:rwkv_scan_ref``): for each (batch, head), with the state S
as [hd_k, hd_v] in f32,

    y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S      <- diag(w_t) @ S + k_t (outer) v_t

``rwkv_scan`` takes its plain PyTorch version (``rwkv_scan_plain``, a time
loop with the same f32 math) for tensors on the CPU and launches
``csrc/rwkv_scan.cu`` for tensors on the card; there is no other path.  The
kernel spreads each value column's state over ``LANES`` lanes and each
(batch, head) over ``column_split`` CTAs.  ``rwkv_scan.launches`` counts
kernel launches.  Unlike the Pallas wrapper it
starts from a given state, returns the end state, and takes any S: S = 1 is
a decode step, S = 0 returns the state with no launch.

When grad mode is on and an input requires grad, ``rwkv_scan`` goes through
``RwkvScanFn`` (float32 inputs only): its forward also saves the state
before every ``CHUNK``-th step (``ckpt``), so autograd keeps O(S / 64)
states, as the JAX package's ``chunked_time_scan`` does; its backward is
``rwkv_scan_bwd`` (``csrc/rwkv_scan_bwd.cu``, counted by
``rwkv_scan_bwd.launches``; ``rwkv_scan_bwd_plain`` on the CPU), which
recomputes each chunk's states from ``ckpt`` and steps back through it, a
head's value columns split over ``bwd_split`` CTAs.
Kernel and plain version do the same f32 roundings in the same order, in
the forward and in the backward.
"""

from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import _build, _local
from repro_torch.kernels.flash_attention import DTYPES, _wants_grad

HEAD_DIMS = (16, 32, 64)       # powers of two: the pairwise sum halves hd
LANES = 4            # the kernel's lanes a column group (its kLanes)
COLS = 2             # the value columns a lane holds (its kCols)
TARGET_CTAS = 128    # about one CTA on each of the H100's 132 SMs
CHUNK = 64           # steps between two saved states (the kernels' kChunk)
# the backward kernel's lane layout by head dim: (lanes a column group,
# value columns a lane), each lane 2 rows; the steps it takes back between
# two of its cluster's sums (its kSteps); its CTAs' warps and its clusters'
# CTAs at most (kMaxWarps, kMaxSplit)
BWD_LAYOUT = {16: (8, 4), 32: (16, 4), 64: (32, 4)}
BWD_STEPS = 8
BWD_MAX_WARPS = 8
BWD_MAX_SPLIT = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 9 + [_I] * 7 + [_P]
_BWD_ARGTYPES = [_P] * 13 + [_I] * 5 + [_P]


def column_split(B, H, hd):
    """CTAs per (batch, head) of the kernel: the least power of two that
    gives ``TARGET_CTAS`` CTAs, each CTA at least a warp (32 // LANES
    groups of COLS value columns)."""
    split, min_cols = 1, 32 // LANES * COLS
    while B * H * split < TARGET_CTAS and hd // (2 * split) >= min_cols:
        split *= 2
    return split


def bwd_splits(hd):
    """The splits the backward kernel takes at head dim ``hd``: powers of
    two from the one that keeps a CTA within ``BWD_MAX_WARPS`` warps to the
    one that leaves it a single warp, at most ``BWD_MAX_SPLIT``."""
    lanes, cols = BWD_LAYOUT[hd]
    warps = hd // (32 // lanes * cols)          # warps a head
    split, out = max(1, warps // BWD_MAX_WARPS), []
    while split <= min(warps, BWD_MAX_SPLIT):
        out.append(split)
        split *= 2
    return tuple(out)


def bwd_split(B, H, hd):
    """CTAs (a thread-block cluster) per (batch, head) of the backward
    kernel: the least split it takes that gives ``TARGET_CTAS`` CTAs, else
    its largest."""
    splits = bwd_splits(hd)
    return next((s for s in splits if B * H * s >= TARGET_CTAS), splits[-1])


def n_chunks(S):
    """The chunk states of a scan over S steps: ceil(S / ``CHUNK``)."""
    return -(-S // CHUNK)


def _check_f32_state(what, name, s, shape, device):
    if (not isinstance(s, torch.Tensor) or tuple(s.shape) != shape
            or s.dtype != torch.float32 or s.device != device
            or not s.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous float32 "
                         f"{shape} tensor on {device}")


def check_scan_inputs(r, k, v, w, u, state, state_out, ckpt=None, *,
                      dy=None, what="rwkv_scan"):
    """Validate the arguments of ``rwkv_scan`` (and, with ``dy`` and no
    ``u``, of ``rwkv_scan_bwd``) on the CPU as on the card; returns (B, S,
    H, hd)."""
    seqs = (("r", r), ("k", k), ("v", v), ("w", w)) + (
        (("dy", dy),) if dy is not None else ())
    names = ", ".join(name for name, _ in seqs)
    for name, x in seqs:
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"{what}: {name} must be a 4-D tensor")
        if x.dtype not in DTYPES:
            raise TypeError(f"{what}: {name} has dtype {x.dtype}; the "
                            "kernel takes float32 or bfloat16")
        if x.shape != r.shape or x.dtype != r.dtype or x.device != r.device:
            raise ValueError(f"{what}: {names} must share shape, dtype "
                             "and device")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if u is not None and (tuple(u.shape) != (H, hd) or u.device != r.device):
        raise ValueError(f"{what}: u {tuple(u.shape)} on {u.device}, "
                         f"expected {(H, hd)} on {r.device}")
    for name, s in (("state", state), ("state_out", state_out)):
        if s is not None:
            _check_f32_state(what, name, s, (B, H, hd, hd), r.device)
    if ckpt is not None:
        _check_f32_state(what, "ckpt", ckpt, (B, H, n_chunks(S), hd, hd),
                         r.device)
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {r.device}")
    return B, S, H, hd


def _end_state(s, state_out):
    if state_out is None:
        return s
    state_out.copy_(s)
    return state_out


def _halving_tree(p, dim):
    """The sum of ``p`` over ``dim`` (a power of two long) as the kernels
    take it: index i with i + n/2, then the same over the first half, ...,
    keeping ``dim`` (of length 1)."""
    while p.shape[dim] > 1:
        half = p.shape[dim] // 2
        p = p.narrow(dim, 0, half) + p.narrow(dim, half, half)
    return p


def _adjacent_tree(p):
    """The sum of ``p`` over its last dim (a power of two long) as the
    backward kernel takes it: j with j ^ 1, then the pairs' sums the same
    way, ..., keeping the dim (of length 1)."""
    while p.shape[-1] > 1:
        p = p[..., 0::2] + p[..., 1::2]
    return p


def rwkv_scan_plain(r, k, v, w, u, state=None, *, state_out=None,
                    ckpt=None):
    """The plain PyTorch version of ``rwkv_scan``: a loop over time with the
    same f32 math (the step of ``rwkv_time_mix``), rounded as the kernel
    rounds it: each product and sum once, and the sum over the key index as
    a fixed pairwise tree (i with i + hd/2, then the same over the halves),
    so that kernel and plain version agree bit for bit.  ``ckpt`` gets the
    state before every ``CHUNK``-th step, as the kernel writes it."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.clone())
    ys = []
    for t in range(S):
        if ckpt is not None and t % CHUNK == 0:
            ckpt[:, :, t // CHUNK] = s
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        p = rf[:, t, :, :, None] * (s + uf * kv)      # [B, H, hd_k, hd_v]
        ys.append(_halving_tree(p, 2)[:, :, 0])
        s = wf[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1).to(r.dtype) if S else torch.empty_like(r)
    return y, _end_state(s, state_out)


def _launch(r, k, v, w, u, state, state_out, ckpt):
    """The forward kernel on card tensors (S >= 1): (y, the end state)."""
    B, S, H, hd = r.shape
    if any(x.data_ptr() % 4 for x in (r, k, v, w)):
        raise ValueError("rwkv_scan: the kernel needs 4-byte aligned r, k, "
                         "v, w")
    uf = u.to(torch.float32).contiguous()
    out = (state_out if state_out is not None else
           torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device))
    y = torch.empty_like(r)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        _build.launch("rwkv_scan", "synergai_rwkv_scan", _ARGTYPES,
                      "synergai_rwkv_error_string",
                      r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      uf.data_ptr(),
                      state.data_ptr() if state is not None else None,
                      out.data_ptr(), y.data_ptr(),
                      ckpt.data_ptr() if ckpt is not None else None,
                      DTYPES[r.dtype], B, S, H, hd, column_split(B, H, hd),
                      int(state is not None), stream)
    rwkv_scan.launches += 1
    return y, out


def _scan(r, k, v, w, u, state, state_out, ckpt):
    """The plain version on CPU tensors, the kernel on card tensors."""
    if r.device.type == "cpu":
        return rwkv_scan_plain(r, k, v, w, u, state, state_out=state_out,
                               ckpt=ckpt)
    if r.numel() == 0:       # no step: the state as it is, no launch
        B, _, H, hd = r.shape
        s = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device) if state is None else state.clone())
        return torch.empty_like(r), _end_state(s, state_out)
    return _launch(r, k, v, w, u, state, state_out, ckpt)


class RwkvScanFn(torch.autograd.Function):
    """``rwkv_scan`` with its gradient (float32 r, k, v, w).  Forward: the
    kernel (the plain version on CPU tensors), the same bits as without a
    gradient, writing the chunk states ``ckpt``; it saves r, k, v, w, u
    and ``ckpt``, O(S / ``CHUNK``) states.  Backward: ``rwkv_scan_bwd``
    for the terms through the state, then the terms without it (du and
    the u-terms of dr, dk and dv) as PyTorch ops, the same on either
    path."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)   # an unused output's is None
        B, S, H, hd = r.shape
        ckpt = torch.empty((B, H, n_chunks(S), hd, hd), dtype=torch.float32,
                           device=r.device)
        y, s_end = _scan(r, k, v, w, u, state, None, ckpt)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.has_state = state is not None
        return y, s_end

    @staticmethod
    def backward(ctx, dy, ds_end):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        dy = (torch.zeros_like(r) if dy is None
              else dy.to(torch.float32).contiguous())
        if ds_end is not None:
            ds_end = ds_end.contiguous()
        dr, dk, dv, dw, ds0 = rwkv_scan_bwd(r, k, v, w, ckpt, dy, ds_end)
        # the terms without the state: a_t = sum_j dy_t v_t
        uf = u.to(torch.float32)[None, None]
        a = (dy * v).sum(-1, keepdim=True)
        uk = uf * k
        dr = dr + uk * a
        dk = dk + (r * uf) * a
        dv = dv + (r * uk).sum(-1, keepdim=True) * dy
        du = (r * k * a).sum((0, 1))
        return dr, dk, dv, dw, du.to(u.dtype), (ds0 if ctx.has_state
                                                 else None)


def rwkv_scan(r, k, v, w, u, state=None, *, state_out=None):
    """r, k, v, w: [B, S, H, hd], one dtype (float32 or bfloat16),
    contiguous, on one device; w is the per-token decay in (0, 1).  u:
    [H, hd] (cast to f32).  ``state``: [B, H, hd, hd] f32, None for zeros.
    Returns (y [B, S, H, hd] in r's dtype, the end state [B, H, hd, hd]
    f32), the end state written to ``state_out`` when it is given;
    ``state_out`` may be ``state`` itself (an update in place).  Through
    ``RwkvScanFn`` when grad mode is on and an input requires grad (float32
    inputs, no ``state_out``).  On DTensors the same call runs on the local
    shards: r's batch and head shards kept where they divide, the sequence
    and head_dim whole; a ``state_out`` must already be laid out so (batch
    on dim 0, heads on dim 1), and its local shard is written."""
    if isinstance(r, DTensor):
        return _sharded_scan(r, k, v, w, u, state, state_out)
    return _rwkv_scan(r, k, v, w, u, state, state_out)


def _rwkv_scan(r, k, v, w, u, state, state_out):
    check_scan_inputs(r, k, v, w, u, state, state_out)
    if _wants_grad(*(t for t in (r, k, v, w, u, state) if t is not None)):
        if r.dtype != torch.float32:
            raise TypeError(f"rwkv_scan: a gradient takes float32 r, k, v, "
                            f"w, not {r.dtype}")
        if state_out is not None:
            raise ValueError("rwkv_scan: no state_out when a gradient is "
                             "asked for")
        return RwkvScanFn.apply(r, k, v, w, u, state)
    return _scan(r, k, v, w, u, state, state_out, None)


rwkv_scan.launches = 0


def _sharded_scan(r, k, v, w, u, state, state_out):
    pl = _local.kept(r, {0: r.shape[0], 2: r.shape[2]})
    u_pl = [Shard(0) if p == Shard(2) else Replicate() for p in pl]
    s_pl = _local.moved(pl, {0: 0, 2: 1})
    out_local = None
    if state_out is not None:
        if (not isinstance(state_out, DTensor)
                or list(state_out.placements) != s_pl):
            raise ValueError(f"rwkv_scan: state_out must be a DTensor laid "
                             f"out as {s_pl}")
        out_local = state_out.to_local()
    args, in_pl = (r, k, v, w, u), [pl] * 4 + [u_pl]
    grad_pl = in_pl[:4] + [_local.summed_over(pl, 0, u_pl)]
    if state is not None:
        args, in_pl, grad_pl = args + (state,), in_pl + [s_pl], grad_pl + [s_pl]

    def scan(r, k, v, w, u, *state):
        return _rwkv_scan(r, k, v, w, u, state[0] if state else None,
                          out_local)

    return _local.call(scan, args, in_pl, (pl, s_pl), grad_pl)


# ----------------------------------------------------------------------------
# the backward


def rwkv_scan_bwd_plain(r, k, v, w, ckpt, dy, ds_end=None):
    """The plain PyTorch version of ``rwkv_scan_bwd``: the chunks in
    reverse, each chunk's states recomputed from ``ckpt`` with the forward's
    roundings, then a loop back over its steps with G (the gradient of the
    state after the step) from ``ds_end`` (None: zeros):

        dr_t = sum_j dy_t[j] S_{t-1}[:, j]     dk_t = sum_j G_t[:, j] v_t[j]
        dw_t = sum_j G_t[:, j] S_{t-1}[:, j]   dv_t = sum_i G_t[i] k_t[i]
        G_{t-1} = w_t G_t + r_t dy_t^T

    each product rounded once, the sums over j as the adjacent pairwise
    tree and those over i as the forward's tree, as the kernel rounds
    them, so that kernel and plain version agree bit for bit.  Returns
    (dr, dk, dv, dw [B, S, H, hd], the state terms only; the start state's
    gradient [B, H, hd, hd]), all f32."""
    B, S, H, hd = r.shape
    g = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if ds_end is None else ds_end.clone())
    by_j = torch.empty((S, 3, B, H, hd), dtype=torch.float32,
                       device=r.device)
    by_i = torch.empty((S, B, H, hd), dtype=torch.float32, device=r.device)
    for c in reversed(range(n_chunks(S))):
        t0, t1 = c * CHUNK, min(S, (c + 1) * CHUNK)
        states = [ckpt[:, :, c]]
        for t in range(t0, t1 - 1):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            states.append(w[:, t, :, :, None] * states[-1] + kv)
        for t in reversed(range(t0, t1)):
            s = states[t - t0]
            dyt, vt = dy[:, t, :, None, :], v[:, t, :, None, :]
            by_i[t] = _halving_tree(g * k[:, t, :, :, None], 2)[:, :, 0]
            by_j[t] = _adjacent_tree(torch.stack(
                (dyt * s, g * vt, g * s)))[..., 0]
            g = w[:, t, :, :, None] * g + r[:, t, :, :, None] * dyt
    dr, dk, dw = (x.contiguous() for x in by_j.permute(1, 2, 0, 3, 4))
    return dr, dk, by_i.transpose(0, 1).contiguous(), dw, g


def rwkv_scan_bwd(r, k, v, w, ckpt, dy, ds_end=None):
    """The gradient of ``rwkv_scan``'s recurrence through the state:
    r, k, v, w, dy (y's cotangent) [B, S, H, hd] float32, ``ckpt`` the
    forward's chunk states [B, H, ceil(S / 64), hd, hd] f32, ``ds_end`` the
    end state's cotangent [B, H, hd, hd] f32 (None: zeros); contiguous, on
    one device.  Returns (dr, dk, dv, dw [B, S, H, hd], d state_0 [B, H, hd,
    hd]), all f32; dr, dk and dv without their u-terms.  Launches
    ``csrc/rwkv_scan_bwd.cu`` (``bwd_split`` CTAs a head) on card tensors,
    runs ``rwkv_scan_bwd_plain`` on CPU tensors; S = 0 returns zeros with
    no launch."""
    if not isinstance(ckpt, torch.Tensor):
        raise ValueError("rwkv_scan_bwd: ckpt must be the forward's chunk "
                         "states")
    B, S, H, hd = check_scan_inputs(r, k, v, w, None, None, None, ckpt,
                                    dy=dy, what="rwkv_scan_bwd")
    if r.dtype != torch.float32:
        raise TypeError(f"rwkv_scan_bwd: r, k, v, w, dy have dtype "
                        f"{r.dtype}; the backward takes float32 (the model "
                        "casts them before the scan)")
    if ds_end is not None:
        _check_f32_state("rwkv_scan_bwd", "ds_end", ds_end, (B, H, hd, hd),
                         r.device)
    if r.device.type == "cpu":
        return rwkv_scan_bwd_plain(r, k, v, w, ckpt, dy, ds_end)
    if S == 0:               # no step: the end state's cotangent, no launch
        ds0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=r.device) if ds_end is None
               else ds_end.clone())
        return (*(torch.zeros_like(r) for _ in range(4)), ds0)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    ds0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    kept = torch.empty((B * H, CHUNK // BWD_STEPS, hd, hd),
                       dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        _build.launch("rwkv_scan_bwd", "synergai_rwkv_scan_bwd",
                      _BWD_ARGTYPES, "synergai_rwkv_bwd_error_string",
                      r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      ckpt.data_ptr(), dy.data_ptr(),
                      ds_end.data_ptr() if ds_end is not None else None,
                      dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      dw.data_ptr(), ds0.data_ptr(), kept.data_ptr(), B, S,
                      H, hd, bwd_split(B, H, hd), stream)
    rwkv_scan_bwd.launches += 1
    return dr, dk, dv, dw, ds0


rwkv_scan_bwd.launches = 0
