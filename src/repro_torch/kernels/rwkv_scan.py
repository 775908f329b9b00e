"""The RWKV6 WKV recurrence on a hand-written CUDA kernel, carrying the
state in and out.

The counterpart of ``repro/kernels/rwkv_scan.py`` (and of
``kernels/ref.py:rwkv_scan_ref``): for each (batch, head), with the state S
as [hd_k, hd_v] in f32,

    y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
    S      <- diag(w_t) @ S + k_t (outer) v_t

``rwkv_scan`` takes its plain PyTorch version (``rwkv_scan_plain``, a time
loop with the same f32 math) for tensors on the CPU and launches
``csrc/rwkv_scan.cu`` for tensors on the card; there is no other path.
``rwkv_scan.launches`` counts kernel launches.  Unlike the Pallas wrapper it
starts from a given state, returns the end state, and takes any S: S = 1 is
a decode step, S = 0 returns the state with no launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (16, 32, 64)       # powers of two: the pairwise sum halves hd

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 6 + [_P]


def check_scan_inputs(r, k, v, w, u, state, state_out):
    """Validate the arguments of ``rwkv_scan`` (on the CPU as on the card);
    returns (B, S, H, hd)."""
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise ValueError(f"rwkv_scan: {name} must be a 4-D tensor")
        if x.dtype not in DTYPES:
            raise TypeError(f"rwkv_scan: {name} has dtype {x.dtype}; the "
                            "kernel takes float32 or bfloat16")
        if x.shape != r.shape or x.dtype != r.dtype or x.device != r.device:
            raise ValueError("rwkv_scan: r, k, v, w must share shape, dtype "
                             "and device")
        if not x.is_contiguous():
            raise ValueError(f"rwkv_scan: {name} must be contiguous")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv_scan: head_dim {hd} is not one of "
                         f"{HEAD_DIMS}")
    if tuple(u.shape) != (H, hd) or u.device != r.device:
        raise ValueError(f"rwkv_scan: u {tuple(u.shape)} on {u.device}, "
                         f"expected {(H, hd)} on {r.device}")
    for name, s in (("state", state), ("state_out", state_out)):
        if s is None:
            continue
        if (tuple(s.shape) != (B, H, hd, hd) or s.dtype != torch.float32
                or s.device != r.device or not s.is_contiguous()):
            raise ValueError(f"rwkv_scan: {name} must be a contiguous "
                             f"float32 {(B, H, hd, hd)} tensor on "
                             f"{r.device}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rwkv_scan runs on cpu or cuda, not {r.device}")
    return B, S, H, hd


def _end_state(s, state_out):
    if state_out is None:
        return s
    state_out.copy_(s)
    return state_out


def rwkv_scan_plain(r, k, v, w, u, state=None, *, state_out=None):
    """The plain PyTorch version of ``rwkv_scan``: a loop over time with the
    same f32 math (the step of ``rwkv_time_mix``), rounded as the kernel
    rounds it: each product and sum once, and the sum over the key index as
    a fixed pairwise tree (i with i + hd/2, then the same over the halves),
    so that kernel and plain version agree bit for bit."""
    B, S, H, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state is None else state.clone())
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        p = rf[:, t, :, :, None] * (s + uf * kv)      # [B, H, hd_k, hd_v]
        while p.shape[2] > 1:
            half = p.shape[2] // 2
            p = p[:, :, :half] + p[:, :, half:]
        ys.append(p[:, :, 0])
        s = wf[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1).to(r.dtype) if S else torch.empty_like(r)
    return y, _end_state(s, state_out)


def rwkv_scan(r, k, v, w, u, state=None, *, state_out=None):
    """r, k, v, w: [B, S, H, hd], one dtype (float32 or bfloat16),
    contiguous, on one device; w is the per-token decay in (0, 1).  u:
    [H, hd] (cast to f32).  ``state``: [B, H, hd, hd] f32, None for zeros.
    Returns (y [B, S, H, hd] in r's dtype, the end state [B, H, hd, hd]
    f32), the end state written to ``state_out`` when it is given;
    ``state_out`` may be ``state`` itself (an update in place)."""
    B, S, H, hd = check_scan_inputs(r, k, v, w, u, state, state_out)
    if r.device.type == "cpu":
        return rwkv_scan_plain(r, k, v, w, u, state, state_out=state_out)
    if r.numel() == 0:       # no step: the state as it is, no launch
        s = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                         device=r.device) if state is None else state.clone())
        return torch.empty_like(r), _end_state(s, state_out)
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
                      out.data_ptr(), y.data_ptr(), DTYPES[r.dtype], B, S, H,
                      hd, int(state is not None), stream)
    rwkv_scan.launches += 1
    return y, out


rwkv_scan.launches = 0
