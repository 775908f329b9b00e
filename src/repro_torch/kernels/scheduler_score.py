"""SynergAI Eq. 2-4 scoring and the device-resident tick on hand-written
CUDA kernels.

The counterpart of ``repro/kernels/scheduler_score.py``:

    T_est[j, w]   = preproc[j, w] + q[j] / qps[j, w]          (Eq. 2)
    acceptable    = T_rem[j] >= T_est[j, w]                   (Eq. 3)
    best[j]       = argmin_w T_est[j, w] over acceptable      (Eq. 4)
    urgency[j]    = T_rem[j] - min_w T_est[j, w]

``scheduler_score_v2`` is the fused batched-serving pass: phase slicing of
disaggregated pools, the per-worker queue-depth penalty and the TTFT/TPOT
streaming gates, over the cached solo matrices (``inf`` = infeasible).

``scheduler_tick`` is one whole decision of the device-resident path
(``repro_torch.core.devicecache``): ``tick_score`` gathers the live rows from
the resident pools and scores them with the v2 recipe plus the placement
cost, ``tick_order`` ranks the jobs by (doomed, urgency), and
``greedy_place`` walks them, each taking its cheapest still-open worker.

Each wrapper takes its plain PyTorch version (``*_plain``) for tensors on the
CPU, and launches its CUDA kernel (``csrc/scheduler_score.cu`` for v1 and v2,
``csrc/scheduler_tick.cu`` for the tick) for tensors on the card; there is no
other path.  ``wrapper.launches`` counts kernel launches.  The kernels'
source notes give the TPU kernel each replaces, the bound and the f32 parity
rules.
"""

from __future__ import annotations

import ctypes
import math

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


_P, _I = ctypes.c_void_p, ctypes.c_int
# library -> (C function -> argtypes, error-string function)
_SIGNATURES = {
    "scheduler_score": ({"synergai_score_v1": [_P] * 8 + [_I, _I, _P],
                         "synergai_score_v2": [_P] * 15 + [_I, _I, _P]},
                        "synergai_error_string"),
    "scheduler_tick": ({"synergai_tick_score": [_P] * 20 + [_I] * 5 + [_P],
                        "synergai_greedy_place": [_P] * 5 + [_I, _I, _P]},
                       "synergai_tick_error_string"),
}


def _launch(lib_name, fn_name, *args):
    """Launch ``fn_name`` from the built library ``lib_name`` on the
    current stream; raise if CUDA refused the launch."""
    lib = _build.load(lib_name)
    functions, err_name = _SIGNATURES[lib_name]
    err = getattr(lib, err_name)
    if err.restype is not ctypes.c_char_p:
        for name, argtypes in functions.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = _I
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: {err(rc).decode()}")


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
            _launch("scheduler_score", "synergai_score_v1",
                    *(x.data_ptr() for x in (qps, preproc, queries,
                                             t_remaining, est, best, urg,
                                             acc)),
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
            _launch("scheduler_score", "synergai_score_v2",
                    *(x.data_ptr() for x in (
                        t_solo, prefill, decode, t_remaining, pen, phase,
                        has_ttft, has_tpot, ttft_rem, tpot_qos, dtok, t_eff,
                        acc, urg, doom)),
                    J, W, stream)
        scheduler_score_v2.launches += 1
    return t_eff, acc, urg, doom


scheduler_score_v2.launches = 0


# ---------------------------------------------------------------------------
# the device-resident tick: gather + score, urgency order, greedy walk


def _tick_checks(pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem,
                 ttft_rem, tpot_qos, dtok, has_ttft, has_tpot, phase, ekey,
                 emask, pen, busy_wait, escale, use_energy):
    cap, Wp = pool_t.shape
    Jp = slots.shape[0]
    dev = pool_t.device
    pools = [("pool_t", pool_t), ("pool_pre", pool_pre),
             ("pool_dec", pool_dec)]
    if use_energy:
        pools.append(("pool_ene", pool_ene))
    for name, x in pools:
        _check(name, x, (cap, Wp), _F32, dev)
    for name, x in (("t_rem", t_rem), ("ttft_rem", ttft_rem),
                    ("tpot_qos", tpot_qos), ("dtok", dtok)):
        _check(name, x, (Jp,), _F32, dev)
    for name, x in (("slots", slots), ("has_ttft", has_ttft),
                    ("has_tpot", has_tpot), ("phase", phase),
                    ("ekey", ekey)):
        _check(name, x, (Jp,), _I32, dev)
    _check("emask", emask, (emask.shape[0], Wp), torch.bool, dev)
    for name, x in (("pen", pen), ("busy_wait", busy_wait),
                    ("escale", escale)):
        _check(name, x, (Wp,), _F32, dev)
    if cap == 0 or Wp == 0 or emask.shape[0] == 0:
        raise ValueError("scheduler_tick needs a non-empty pool and emask")
    return Jp, cap, Wp, dev


def tick_score_plain(pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem,
                     ttft_rem, tpot_qos, dtok, has_ttft, has_tpot, phase,
                     ekey, emask, pen, busy_wait, escale, use_energy=False):
    """The plain PyTorch version of ``tick_score`` (same f32 math)."""
    idx = slots.clamp(0, pool_t.shape[0] - 1).long()
    t_eff, acc, urg, doom = scheduler_score_v2_plain(
        pool_t[idx], pool_pre[idx], pool_dec[idx], t_rem, pen, phase,
        has_ttft, has_tpot, ttft_rem, tpot_qos, dtok)
    doomed = (doom != 0)[:, None]
    feas = torch.isfinite(t_eff)
    costd = t_eff + busy_wait
    best = torch.where(feas, costd, torch.inf).amin(dim=1, keepdim=True)
    eligd = feas & (t_eff <= 1.5 * best)
    cost = torch.where(doomed, costd, t_eff)
    elig = torch.where(doomed, eligd, acc != 0)
    if use_energy:
        cost = cost + pool_ene[idx] * escale
    key = ekey.clamp(0, emask.shape[0] - 1).long()
    elig = elig & emask[key] & (slots >= 0)[:, None]
    return torch.where(elig, cost, torch.inf), urg, doom


def tick_score(pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem, ttft_rem,
               tpot_qos, dtok, has_ttft, has_tpot, phase, ekey, emask, pen,
               busy_wait, escale, use_energy=False):
    """The scoring half of ``scheduler_tick``: gather each row's pool rows
    by ``slots`` (-1 = padding, clipped to row 0) and score them with the v2
    recipe plus the placement-cost prep.  Returns (ranked [Jp, Wp] f32 —
    the ranking cost where eligible, else inf; urgency [Jp] f32; doomed
    [Jp] i8)."""
    Jp, cap, Wp, dev = _tick_checks(
        pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem, ttft_rem,
        tpot_qos, dtok, has_ttft, has_tpot, phase, ekey, emask, pen,
        busy_wait, escale, use_energy)
    if dev.type == "cpu":
        return tick_score_plain(pool_t, pool_pre, pool_dec, pool_ene, slots,
                                t_rem, ttft_rem, tpot_qos, dtok, has_ttft,
                                has_tpot, phase, ekey, emask, pen, busy_wait,
                                escale, use_energy)
    if dev.type != "cuda":
        raise ValueError(f"tick_score runs on cpu or cuda, not {dev}")
    ranked = torch.empty((Jp, Wp), dtype=_F32, device=dev)
    urg = torch.empty((Jp,), dtype=_F32, device=dev)
    doom = torch.empty((Jp,), dtype=torch.int8, device=dev)
    if Jp:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch("scheduler_tick", "synergai_tick_score",
                    *(x.data_ptr() for x in (
                        pool_t, pool_pre, pool_dec)),
                    pool_ene.data_ptr() if use_energy else None,
                    *(x.data_ptr() for x in (
                        slots, t_rem, ttft_rem, tpot_qos, dtok, has_ttft,
                        has_tpot, phase, ekey, emask, pen, busy_wait,
                        escale, ranked, urg, doom)),
                    Jp, cap, Wp, emask.shape[0], int(bool(use_energy)),
                    stream)
        tick_score.launches += 1
    return ranked, urg, doom


tick_score.launches = 0


def _sort_key(x):
    """int32 keys in the order ``jnp.lexsort`` sorts float32 ``x``: -0.0
    equal to 0.0, every NaN equal and after +inf."""
    bits = torch.where(x == 0.0, 0.0, x).view(_I32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(x), 0x7FC00000, key)


def tick_order(urg, doom, slots):
    """The placement order of ``scheduler_tick``: a stable lexsort by
    (doomed, urgency) with padding rows (slot -1) last, as ``jnp.lexsort``
    orders them.  One stable sort of an int64 key: the doom key (0, 1, or 2
    for padding) above the urgency's order-preserving int32 image."""
    valid = slots >= 0
    doomkey = torch.where(valid, doom.to(torch.int64), 2)
    urgkey = torch.where(valid, urg, torch.inf)
    key = doomkey * (1 << 32) + (_sort_key(urgkey).to(torch.int64)
                                 + (1 << 31))
    return torch.sort(key, stable=True).indices.to(_I32)


def greedy_place_plain(ranked, order, slots, open0):
    """The plain PyTorch version of ``greedy_place``."""
    assign = torch.full((ranked.shape[0],), -1, dtype=_I32,
                        device=ranked.device)
    open_slot = open0.clone()
    n_open = int(open_slot.sum())
    valid = (slots >= 0).tolist()
    for ji in order.tolist():
        if n_open == 0 or not valid[ji]:
            break
        cand = torch.where(open_slot, ranked[ji], torch.inf)
        wi = int(torch.argmin(cand))
        if math.isfinite(float(cand[wi])):
            assign[ji] = wi
            open_slot[wi] = False
            n_open -= 1
    return assign


def greedy_place(ranked, order, slots, open0):
    """The placement half of ``scheduler_tick``: walk the jobs in
    ``order``; each takes the lowest-index argmin of its ``ranked`` row over
    the still-open workers if that is finite (a NaN wins the argmin and
    places nothing).  Stops once no worker is open or at the first padded
    row (slot -1).  Returns assign [Jp] i32 (worker index or -1)."""
    Jp, Wp = ranked.shape
    dev = ranked.device
    _check("ranked", ranked, (Jp, Wp), _F32, dev)
    _check("order", order, (Jp,), _I32, dev)
    _check("slots", slots, (Jp,), _I32, dev)
    _check("open0", open0, (Wp,), torch.bool, dev)
    if Wp == 0:
        raise ValueError("greedy_place needs at least one worker")
    if dev.type == "cpu":
        return greedy_place_plain(ranked, order, slots, open0)
    if dev.type != "cuda":
        raise ValueError(f"greedy_place runs on cpu or cuda, not {dev}")
    assign = torch.empty((Jp,), dtype=_I32, device=dev)
    if Jp:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            _launch("scheduler_tick", "synergai_greedy_place",
                    *(x.data_ptr() for x in (ranked, order, slots, open0,
                                             assign)),
                    Jp, Wp, stream)
        greedy_place.launches += 1
    return assign


greedy_place.launches = 0


def scheduler_tick_plain(pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem,
                         ttft_rem, tpot_qos, dtok, has_ttft, has_tpot, phase,
                         ekey, emask, pen, busy_wait, escale, open0, *,
                         use_energy=False):
    """The plain PyTorch version of ``scheduler_tick``."""
    ranked, urg, doom = tick_score_plain(
        pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem, ttft_rem,
        tpot_qos, dtok, has_ttft, has_tpot, phase, ekey, emask, pen,
        busy_wait, escale, use_energy)
    order = tick_order(urg, doom, slots)
    return greedy_place_plain(ranked, order, slots, open0), order


def scheduler_tick(pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem,
                   ttft_rem, tpot_qos, dtok, has_ttft, has_tpot, phase, ekey,
                   emask, pen, busy_wait, escale, open0, *,
                   use_energy=False):
    """One whole scheduling decision on the device, the reference's
    argument list: pools [cap, Wp] f32 (``pool_ene`` read only with
    ``use_energy``); slots [Jp] i32 (-1 = padding); t_rem, ttft_rem,
    tpot_qos, dtok [Jp] f32; has_ttft, has_tpot, phase, ekey [Jp] i32;
    emask [K, Wp] bool; pen, busy_wait, escale [Wp] f32; open0 [Wp] bool.
    Returns (assign [Jp] i32 — worker index or -1, order [Jp] i32 — the
    urgency-sorted placement order): two kernels with the sort between."""
    ranked, urg, doom = tick_score(
        pool_t, pool_pre, pool_dec, pool_ene, slots, t_rem, ttft_rem,
        tpot_qos, dtok, has_ttft, has_tpot, phase, ekey, emask, pen,
        busy_wait, escale, use_energy)
    order = tick_order(urg, doom, slots)
    return greedy_place(ranked, order, slots, open0), order
