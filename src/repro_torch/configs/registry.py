# Port of repro/configs/registry.py: the same data, imports rewritten to repro_torch.
"""Architecture config registry: ``--arch <id>`` resolution."""

from __future__ import annotations

from repro_torch.configs import (deepseek_v2_236b, gemma_2b, h2o_danube_1_8b,
                           hymba_1_5b, llama32_vision_11b, phi35_moe_42b,
                           qwen3_32b, qwen3_4b, rwkv6_1_6b,
                           seamless_m4t_medium)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeCell, reduced

ARCHS = {
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "gemma-2b": gemma_2b.CONFIG,
    "qwen3-32b": qwen3_32b.CONFIG,
    "qwen3-4b": qwen3_4b.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    "llama-3.2-vision-11b": llama32_vision_11b.CONFIG,
    "phi3.5-moe-42b-a6.6b": phi35_moe_42b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def get_shape(name: str) -> ShapeCell:
    return SHAPES[name]


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether a (arch x shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention (documented skip)")
    return True, ""


def all_cells():
    """Every assigned (arch, shape) cell with its applicability."""
    for arch, cfg in ARCHS.items():
        for shape in SHAPES.values():
            ok, why = cell_applicable(cfg, shape)
            yield arch, cfg, shape, ok, why


__all__ = ["ARCHS", "get_config", "get_shape", "cell_applicable",
           "all_cells", "reduced", "SHAPES"]
