"""SynergAI scoring on the port's CUDA kernels — drop-in ``score_fn``s.

The counterpart of ``repro/core/pallas_scoring.py``.
``make_torch_score_fn()`` builds the dense ``[J, W]`` qps/preproc matrices
from the Configuration Dictionary (``score_matrices``), runs
``repro_torch.kernels.scheduler_score.scheduler_score`` on the card and
adapts its outputs to ``ScoreResult``, so that

    SynergAI(score_fn=make_torch_score_fn())

is a drop-in replacement for the default numpy path.
``make_torch_score_fn(v2=True)`` returns the fused backend
(``scheduler_score_v2``: depth penalty, phase slicing and TTFT/TPOT gates in
the same pass), which ``SynergAI._schedule_fused`` calls with the cached solo
matrices and the per-tick cluster vectors.
``make_torch_score_fn(device_cache=True)`` returns the device-resident
backend: a marker from which ``SynergAI`` builds a
``repro_torch.core.devicecache.DeviceScoreCache`` on the marker's device, and
every tick then runs through ``scheduler_tick``.

``device=None`` means the card and raises without one; ``device="cpu"`` runs
the kernels' plain PyTorch versions.  Both score in float32, so a budget that
ties an estimate at the last float64 bit may flip between acceptable and
doomed relative to the numpy scorer, exactly as the Pallas path does.

Each score function keeps ``seconds``: host-clock time per stage summed over
its calls (``build`` the host inputs, ``h2d`` copies, ``kernel``, ``d2h``
copies and host outputs), with the device synchronised between stages;
``calls``, the number of calls that launched a kernel; and ``rows``, the job
rows those calls scored.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.estimator import ScoreResult, score_matrices
from repro_torch.kernels.scheduler_score import (scheduler_score,
                                                 scheduler_score_v2)


class _Stages:
    """Host-clock stage timer: ``lap(name)`` charges the time since the
    previous lap to ``name``, after the device has finished its work."""

    def __init__(self, dev: torch.device, seconds: dict):
        self.sync = dev.type == "cuda"
        self.dev = dev
        self.seconds = seconds
        self.t = time.perf_counter()

    def lap(self, name: str):
        if self.sync:
            torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        self.seconds[name] += t - self.t
        self.t = t


def _new_seconds() -> dict:
    return {"build": 0.0, "h2d": 0.0, "kernel": 0.0, "d2h": 0.0}


def make_torch_score_fn(v2: bool = False, device=None,
                        device_cache: bool = False):
    dev = resolve_device(device)
    if device_cache:
        return _make_device_marker(dev)
    if v2:
        return _make_fused_score_fn(dev)

    def score_fn(cd, jobs, workers, now, use_default=False,
                 token=None) -> ScoreResult:
        if not jobs:
            return ScoreResult.empty(workers)
        clock = _Stages(dev, score_fn.seconds)
        t_rem = np.array([j.t_qos - (now - j.arrival) for j in jobs])
        qps, pre = score_matrices(cd, jobs, workers, use_default, token)
        q = np.array([float(j.queries) for j in jobs], np.float32)
        host = (qps.astype(np.float32), pre.astype(np.float32), q,
                t_rem.astype(np.float32))
        clock.lap("build")
        args = [torch.from_numpy(a).to(dev) for a in host]
        clock.lap("h2d")
        out = scheduler_score(*args)
        clock.lap("kernel")
        est, best, urg, acc = (x.cpu().numpy() for x in out)
        # BIG-sentinel entries (qps <= 0) become inf so candidate_order's
        # feasibility filter behaves exactly like the numpy path
        t_est = np.where(qps > 0, est.astype(np.float64), np.inf)
        acceptable = acc.astype(bool)
        result = ScoreResult(list(workers), t_est, t_rem, acceptable,
                             best.astype(np.int64), urg.astype(np.float64),
                             ~acceptable.any(axis=1))
        clock.lap("d2h")
        score_fn.calls += 1
        score_fn.rows += len(jobs)
        return result

    score_fn.takes_token = True
    score_fn.device = dev
    score_fn.seconds = _new_seconds()
    score_fn.calls = score_fn.rows = 0
    return score_fn


def _make_device_marker(dev: torch.device):
    """The device-resident backend.  Not a scoring callable: ``SynergAI``
    reads its attributes to build a ``DeviceScoreCache`` (row pools resident
    on ``device``, the job axis padded to a power-of-two multiple of
    ``bj``), and no host-side score function ever runs."""
    def device_score(*_a, **_k):
        raise TypeError(
            "make_torch_score_fn(device_cache=True) returns a backend "
            "marker consumed by SynergAI, not a callable score_fn — the "
            "tick runs through DeviceScoreCache.device_tick")
    device_score.device_cache = True
    device_score.takes_profile = True
    device_score.bj = 128
    device_score.device = dev
    return device_score


def _make_fused_score_fn(dev: torch.device):
    def fused_score(t_solo, pre_m, dec_m, t_rem, pen, phase, has_ttft,
                    has_tpot, ttft_rem, tpot_qos, dtok):
        """(t_eff, acceptable, urgency, doomed) — the fused batched +
        streaming + disaggregated scoring pass, as float64/bool numpy
        (``inf`` marks infeasible pairs, exactly like the numpy path)."""
        clock = _Stages(dev, fused_score.seconds)
        f32 = lambda a: np.ascontiguousarray(a, np.float32)
        i32 = lambda a: np.ascontiguousarray(a, np.int32)
        host = (f32(t_solo), f32(pre_m), f32(dec_m), f32(t_rem), f32(pen),
                i32(phase), i32(has_ttft), i32(has_tpot), f32(ttft_rem),
                f32(tpot_qos), f32(dtok))
        clock.lap("build")
        args = [torch.from_numpy(a).to(dev) for a in host]
        clock.lap("h2d")
        out = scheduler_score_v2(*args)
        clock.lap("kernel")
        est, acc, urg, doom = (x.cpu().numpy() for x in out)
        result = (est.astype(np.float64), acc.astype(bool),
                  urg.astype(np.float64), doom.astype(bool))
        clock.lap("d2h")
        if len(est):
            fused_score.calls += 1
            fused_score.rows += len(est)
        return result

    fused_score.fused = True
    fused_score.device = dev
    fused_score.seconds = _new_seconds()
    fused_score.calls = fused_score.rows = 0
    return fused_score
