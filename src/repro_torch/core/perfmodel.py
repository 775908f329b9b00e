# Port of repro/core/perfmodel.py: the same numpy code, imports rewritten to repro_torch.
"""Roofline performance model: QPS / preprocessing / energy per
(engine x worker x operating mode x chips-per-replica).

This is the measurement instrument of the offline phase.  On real hardware
the numbers would come from profiling runs (as in the paper); in this
container they come from a three-term roofline over analytic FLOPs/bytes —
the same three terms the dry-run extracts from compiled HLO (§Roofline in
EXPERIMENTS.md), so the scheduler is agnostic to the source.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.constants import (ENGINE_INIT_S, HOST_TOKENIZE_S_PER_MB,
                                  ICI_BW, ICI_LINKS, MODEL_LOAD_GBPS,
                                  OperatingMode)
from repro_torch.core.engines import EngineSpec
from repro_torch.core.workers import WorkerPool

HOP_LATENCY_S = 1e-6          # per-ICI-hop latency
STEP_OVERHEAD_S = 30e-6       # host dispatch per executed step
HBM_UTIL = 0.9                # usable fraction of HBM


@dataclasses.dataclass(frozen=True)
class EngineProfile:
    """Analytic per-query workload numbers for one engine."""

    weights_bytes: float
    prefill_flops: float          # per microbatch of queries
    prefill_bytes: float
    decode_flops_per_step: float  # per microbatch decode step
    decode_bytes_per_step: float
    kv_bytes: float               # cache footprint at full context
    coll_bytes_per_step: float    # TP all-reduce payload per layer-pass
    n_steps: int                  # decode steps per query
    microbatch: int


def profile_engine(engine: EngineSpec) -> EngineProfile:
    cfg = engine.cfg
    mb = engine.microbatch
    P, G = engine.prefill_len, engine.decode_len
    bpp = engine.bytes_per_param
    n_active = cfg.active_param_count
    n_total = cfg.param_count
    L, D, H, K, hd = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                      cfg.n_kv_heads, cfg.head_dim)

    weights = n_total * bpp
    ctx = P + G

    # attention score+value FLOPs (quadratic part)
    if cfg.sub_quadratic and cfg.sliding_window:
        eff_ctx = min(ctx, cfg.sliding_window)
    elif cfg.family == "ssm":
        eff_ctx = 0  # recurrence counted via params
    else:
        eff_ctx = ctx
    attn_prefill = 4 * L * H * hd * P * min(P, eff_ctx or P) * mb
    prefill_flops = 2 * n_active * P * mb + attn_prefill
    prefill_bytes = weights + 4 * P * mb * D * L * bpp

    kv_per_tok = (2 * L * K * hd * bpp if cfg.family != "ssm"
                  else 0.0)
    if cfg.mla is not None:
        kv_per_tok = L * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * bpp
    if cfg.family == "ssm":
        hd_r = cfg.ssm.rwkv_head_dim
        kv_state = L * (D // hd_r) * hd_r * hd_r * 4  # f32 state
    else:
        kv_state = kv_per_tok * min(ctx, eff_ctx or ctx)
    kv_bytes = kv_state * mb

    attn_decode = 4 * L * H * hd * (eff_ctx or 1) * mb
    decode_flops = 2 * n_active * mb + attn_decode
    # decode streams every live weight + reads the cache once
    decode_bytes = weights + kv_bytes + 2 * mb * D * L * bpp

    # tensor-parallel payload: 2 all-reduces of [mb, D] per layer
    coll_bytes = 4 * L * mb * D * 2.0

    return EngineProfile(weights, prefill_flops, prefill_bytes,
                         decode_flops, decode_bytes, kv_bytes, coll_bytes,
                         G, mb)


@dataclasses.dataclass(frozen=True)
class ConfigPoint:
    """One point of the per-worker configuration space."""

    mode: OperatingMode
    chips_per_replica: int

    def key(self) -> str:
        return f"{self.mode.name}/r{self.chips_per_replica}"


@dataclasses.dataclass(frozen=True)
class PerfEstimate:
    qps: float                    # queries per second (0 if infeasible)
    query_time_s: float
    preproc_s: float
    power_w: float
    energy_per_query_j: float
    feasible: bool
    bottleneck: str
    decode_frac: float = 0.85     # share of query_time_s in per-token decode
    idle_power_w: float = 0.0     # static floor of the slice at this mode


def estimate(engine: EngineSpec, worker: WorkerPool,
             point: ConfigPoint) -> PerfEstimate:
    prof = profile_engine(engine)
    mode = point.mode
    r = point.chips_per_replica
    chips_online = min(mode.chips_online, worker.n_chips)
    if r > chips_online:
        return PerfEstimate(0.0, math.inf, math.inf, 0.0, math.inf, False,
                            "infeasible:chips")
    # replica must fit: weights + cache + ~20% activations headroom
    need = (prof.weights_bytes + prof.kv_bytes) * 1.2
    if need > r * worker.chip_hbm_bytes * HBM_UTIL:
        return PerfEstimate(0.0, math.inf, math.inf, 0.0, math.inf, False,
                            "infeasible:hbm")

    c = mode.effective_clock()
    peak = worker.chip_flops * (2.0 if engine.precision == "int8" else 1.0)
    flops_rate = r * peak * c
    hbm_rate = r * worker.chip_hbm_bw * c
    ici_rate = ICI_BW * ICI_LINKS / 2  # per-chip usable collective bandwidth

    def phase(flops, byts, steps=1):
        compute = flops / flops_rate
        memory = byts / hbm_rate
        if r > 1:
            ring = 2 * (r - 1) / r
            coll = (prof.coll_bytes_per_step * ring / r) / ici_rate
            coll += 2 * engine.cfg.n_layers * (r - 1) * HOP_LATENCY_S
        else:
            coll = 0.0
        t = max(compute, memory, coll) + STEP_OVERHEAD_S
        dom = max((compute, "compute"), (memory, "memory"),
                  (coll, "collective"))[1]
        return t * steps, dom

    t_prefill, dom_p = phase(prof.prefill_flops, prof.prefill_bytes)
    t_dec_step, dom_d = phase(prof.decode_flops_per_step,
                              prof.decode_bytes_per_step)
    t_decode = prof.n_steps * t_dec_step
    query_time = t_prefill + t_decode
    qps = prof.microbatch / query_time
    decode_frac = t_decode / query_time

    preproc = (ENGINE_INIT_S + prof.weights_bytes / MODEL_LOAD_GBPS
               + HOST_TOKENIZE_S_PER_MB
               * (prof.microbatch * engine.prefill_len * 4 / 1e6))
    power = mode.power_w()
    energy = power * query_time / prof.microbatch
    bottleneck = dom_d if t_decode > t_prefill else dom_p
    return PerfEstimate(qps, query_time, preproc, power, energy, True,
                        bottleneck, decode_frac, mode.idle_power_w())


def config_space(engine: EngineSpec, worker: WorkerPool):
    """All (mode x chips-per-replica) points for a worker."""
    points = []
    for mode in worker.modes:
        online = min(mode.chips_online, worker.n_chips)
        r = 1
        while r <= online:
            points.append(ConfigPoint(mode, r))
            r *= 2
        if online not in [p.chips_per_replica for p in points
                          if p.mode == mode]:
            points.append(ConfigPoint(mode, online))
    return points
