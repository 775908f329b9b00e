"""SynergAI Eq. 2-4 scoring on hand-written CUDA kernels (v1 + fused v2).

The counterpart of ``repro/kernels/scheduler_score.py`` (v1 and v2 halves):

    T_est[j, w]   = preproc[j, w] + q[j] / qps[j, w]          (Eq. 2)
    acceptable    = T_rem[j] >= T_est[j, w]                   (Eq. 3)
    best[j]       = argmin_w T_est[j, w] over acceptable      (Eq. 4)
    urgency[j]    = T_rem[j] - min_w T_est[j, w]

``scheduler_score_v2`` is the fused batched-serving pass: phase slicing of
disaggregated pools, the per-worker queue-depth penalty and the TTFT/TPOT
streaming gates, over the cached solo matrices (``inf`` = infeasible).

Each wrapper takes its plain PyTorch version (``*_plain``) for tensors on the
CPU, and launches its CUDA kernel (``csrc/scheduler_score.cu``) for tensors
on the card; there is no other path.  ``wrapper.launches`` counts kernel
launches.  The kernels' source note gives the TPU kernel each replaces, the
bound (bytes: v1 moves 13 B per cell, v2 17 B) and the f32 parity rules.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BIG = 3.0e38

_F32, _I32 = torch.float32, torch.int32


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x)}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(fn_name, *args):
    """Launch ``fn_name`` from the built library on the current stream;
    raise if CUDA refused the launch."""
    lib = _build.load("scheduler_score")
    if lib.synergai_error_string.restype is not ctypes.c_char_p:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.synergai_score_v1.argtypes = [P] * 8 + [I, I, P]
        lib.synergai_score_v2.argtypes = [P] * 15 + [I, I, P]
        lib.synergai_score_v1.restype = lib.synergai_score_v2.restype = I
        lib.synergai_error_string.argtypes = [I]
        lib.synergai_error_string.restype = ctypes.c_char_p
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.synergai_error_string(rc).decode()}")


# ---------------------------------------------------------------------------
# v1: Eq. 2-4


def scheduler_score_plain(qps, preproc, queries, t_remaining):
    """The plain PyTorch version of ``scheduler_score`` (same f32 math)."""
    feas = qps > 0.0
    est = torch.where(feas, preproc + queries[:, None]
                      / torch.where(feas, qps, 1.0), BIG)
    acc = feas & (t_remaining[:, None] >= est)
    est_masked = torch.where(acc, est, BIG)
    pick_from = torch.where(acc.any(dim=1, keepdim=True), est_masked, est)
    best = torch.where(feas.any(dim=1), torch.argmin(pick_from, dim=1), -1)
    urgency = t_remaining - est.amin(dim=1)
    return est, best.to(_I32), urgency, acc.to(torch.int8)


def scheduler_score(qps, preproc, queries, t_remaining):
    """qps, preproc: [J, W] f32 (qps <= 0 marks infeasible); queries,
    t_remaining: [J] f32, all on one device.  Returns (t_est [J,W] f32,
    best [J] i32, urgency [J] f32, acceptable [J,W] i8); ``t_est`` is BIG
    on infeasible cells and ``best`` is -1 on rows with none feasible."""
    J, W = qps.shape
    dev = qps.device
    _check("qps", qps, (J, W), _F32, dev)
    _check("preproc", preproc, (J, W), _F32, dev)
    _check("queries", queries, (J,), _F32, dev)
    _check("t_remaining", t_remaining, (J,), _F32, dev)
    if W == 0:
        raise ValueError("scheduler_score needs at least one worker")
    if dev.type == "cpu":
        return scheduler_score_plain(qps, preproc, queries, t_remaining)
    if dev.type != "cuda":
        raise ValueError(f"scheduler_score runs on cpu or cuda, not {dev}")
    est = torch.empty((J, W), dtype=_F32, device=dev)
    best = torch.empty((J,), dtype=_I32, device=dev)
    urg = torch.empty((J,), dtype=_F32, device=dev)
    acc = torch.empty((J, W), dtype=torch.int8, device=dev)
    if J:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch("synergai_score_v1", *(x.data_ptr() for x in (
                qps, preproc, queries, t_remaining, est, best, urg, acc)),
                J, W, stream)
        scheduler_score.launches += 1
    return est, best, urg, acc


scheduler_score.launches = 0


# ---------------------------------------------------------------------------
# v2: fused batched + streaming + disaggregated scoring


def scheduler_score_v2_plain(t_solo, prefill, decode, t_remaining, pen,
                             phase, has_ttft, has_tpot, ttft_rem, tpot_qos,
                             dtok):
    """The plain PyTorch version of ``scheduler_score_v2`` (same f32 math)."""
    ph = phase[:, None]
    hft = (has_ttft != 0)[:, None]
    hpt = (has_tpot != 0)[:, None]
    t_eff = torch.where(ph == 1, prefill,
                        torch.where(ph == 2, decode, t_solo)) * pen
    acc = t_remaining[:, None] >= t_eff
    ttft_est = prefill * pen
    tpot_est = decode * pen / dtok[:, None]
    acc &= ~hft | (ph == 2) | (ttft_est <= ttft_rem[:, None])
    acc &= ~hpt | (ph == 1) | (tpot_est <= tpot_qos[:, None])
    urg = t_remaining - t_solo.amin(dim=1)
    ttft_slack = ttft_rem - ttft_est.amin(dim=1)
    urg = torch.where((has_ttft != 0) & (phase != 2),
                      torch.minimum(urg, ttft_slack), urg)
    doom = ~acc.any(dim=1)
    return t_eff, acc.to(torch.int8), urg, doom.to(torch.int8)


def scheduler_score_v2(t_solo, prefill, decode, t_remaining, pen, phase,
                       has_ttft, has_tpot, ttft_rem, tpot_qos, dtok):
    """t_solo, prefill, decode: [J, W] f32 solo-service matrices (``inf``
    marks infeasible pairs); pen: [W] f32 depth penalty; t_remaining,
    ttft_rem, tpot_qos, dtok: [J] f32; phase: [J] i32 (0 full / 1 prefill /
    2 decode); has_ttft, has_tpot: [J] i32 (0/1).  Returns (t_eff [J,W]
    f32, acceptable [J,W] i8, urgency [J] f32, doomed [J] i8)."""
    J, W = t_solo.shape
    dev = t_solo.device
    for name, x in (("t_solo", t_solo), ("prefill", prefill),
                    ("decode", decode)):
        _check(name, x, (J, W), _F32, dev)
    _check("pen", pen, (W,), _F32, dev)
    for name, x in (("t_remaining", t_remaining), ("ttft_rem", ttft_rem),
                    ("tpot_qos", tpot_qos), ("dtok", dtok)):
        _check(name, x, (J,), _F32, dev)
    for name, x in (("phase", phase), ("has_ttft", has_ttft),
                    ("has_tpot", has_tpot)):
        _check(name, x, (J,), _I32, dev)
    if W == 0:
        raise ValueError("scheduler_score_v2 needs at least one worker")
    if dev.type == "cpu":
        return scheduler_score_v2_plain(t_solo, prefill, decode, t_remaining,
                                        pen, phase, has_ttft, has_tpot,
                                        ttft_rem, tpot_qos, dtok)
    if dev.type != "cuda":
        raise ValueError(f"scheduler_score_v2 runs on cpu or cuda, not {dev}")
    t_eff = torch.empty((J, W), dtype=_F32, device=dev)
    acc = torch.empty((J, W), dtype=torch.int8, device=dev)
    urg = torch.empty((J,), dtype=_F32, device=dev)
    doom = torch.empty((J,), dtype=torch.int8, device=dev)
    if J:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch("synergai_score_v2", *(x.data_ptr() for x in (
                t_solo, prefill, decode, t_remaining, pen, phase, has_ttft,
                has_tpot, ttft_rem, tpot_qos, dtok, t_eff, acc, urg, doom)),
                J, W, stream)
        scheduler_score_v2.launches += 1
    return t_eff, acc, urg, doom


scheduler_score_v2.launches = 0
