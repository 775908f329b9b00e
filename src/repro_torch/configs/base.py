# Port of repro/configs/base.py: the same data, imports rewritten to repro_torch.
"""Model configuration dataclasses shared by every assigned architecture."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0           # per-expert intermediate size
    capacity_factor: float = 1.25  # GShard-style dispatch capacity
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16            # N — per-channel state size
    d_inner_mult: int = 2          # d_inner = mult * d_model
    d_conv: int = 4                # depthwise conv width
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    rwkv_head_dim: int = 64        # RWKV head size
    lora_rank: int = 64            # RWKV6 ddlerp LoRA rank


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    n_vision_tokens: int = 1601    # stubbed frontend: precomputed patch embeds
    d_vision: int = 0              # 0 -> d_model (post-projector width)
    cross_attn_every: int = 5      # a cross-attn layer every N decoder layers


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 12
    d_source: int = 0              # 0 -> d_model (stubbed audio frame embeds)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | moe | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"              # silu -> SwiGLU, gelu -> GeGLU
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    global_layers: Tuple[int, ...] = ()   # layers that stay global under SWA
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    scale_embeddings: bool = False        # gemma-style sqrt(d_model) embed scale
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionConfig] = None
    encdec: Optional[EncDecConfig] = None
    dtype: str = "bfloat16"
    # Serving/runtime knobs (part of the "engine configuration" the SynergAI
    # offline phase tunes per worker):
    remat: bool = True
    attn_chunk: int = 512          # kv-chunk for the XLA flash path
    flash_threshold: int = 2048    # use chunked flash for seq >= threshold

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode is O(1)/O(window) per token."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    @property
    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and load time)."""
        d, L = self.d_model, self.n_layers
        n_emb = self.vocab * d * 2  # in + out embedding (untied)
        per_layer = 0
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_hd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.family == "ssm":  # RWKV6 time-mix
            hd = self.ssm.rwkv_head_dim
            per_layer += 4 * d * d + d * d  # r,k,v,g,o projections
            per_layer += 5 * 2 * d * self.ssm.lora_rank  # ddlerp LoRAs
        else:
            per_layer += d * self.n_heads * self.head_dim  # wq
            per_layer += 2 * d * self.n_kv_heads * self.head_dim  # wk, wv
            per_layer += self.n_heads * self.head_dim * d  # wo
        if self.family == "hybrid":  # parallel mamba branch
            di = self.ssm.d_inner_mult * d
            per_layer += 2 * d * di + di * d + di * self.ssm.d_conv
            per_layer += di * (2 * self.ssm.state_dim + 2)
        if self.moe is not None:
            e = self.moe
            ff = e.d_ff_expert or self.d_ff
            per_layer += d * e.n_experts  # router
            per_layer += (e.n_experts + e.n_shared) * 3 * d * ff
        elif self.family == "ssm":
            per_layer += 2 * d * self.d_ff  # RWKV channel-mix (k, v) + receptance
            per_layer += d * d
        else:
            per_layer += 3 * d * self.d_ff  # SwiGLU/GeGLU
        total = n_emb + L * per_layer
        if self.vision is not None:
            n_cross = L // self.vision.cross_attn_every
            total += n_cross * (2 * d * self.n_kv_heads * self.head_dim)
        if self.encdec is not None:
            # encoder layers + decoder cross-attention
            enc_layer = 4 * d * self.head_dim * self.n_heads + 3 * d * self.d_ff
            total += self.encdec.n_enc_layers * enc_layer
            total += L * (4 * d * self.head_dim * self.n_kv_heads)
        return int(total)

    @property
    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count
        e = self.moe
        ff = e.d_ff_expert or self.d_ff
        d, L = self.d_model, self.n_layers
        inactive = L * (e.n_experts - e.top_k) * 3 * d * ff
        return int(self.param_count - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab=256,
        dtype="float32",
        remat=False,
        flash_threshold=64,
        attn_chunk=32,
    )
    if cfg.moe is not None:
        # generous capacity so smoke tests see no token dropping (capacity
        # dropping is order-dependent and breaks prefill/decode equivalence)
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
            capacity_factor=8.0)
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=8, rwkv_head_dim=16, lora_rank=8)
    if cfg.vision is not None:
        changes["vision"] = dataclasses.replace(
            cfg.vision, n_vision_tokens=17, cross_attn_every=2)
    if cfg.encdec is not None:
        changes["encdec"] = dataclasses.replace(cfg.encdec, n_enc_layers=2)
    if cfg.sliding_window is not None:
        changes["sliding_window"] = 32
    if cfg.global_layers:
        changes["global_layers"] = (0,)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
