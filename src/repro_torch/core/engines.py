# Port of repro/core/engines.py: the same numpy code, imports rewritten to repro_torch.
"""Inference-engine catalogue (paper Table 1 analogue).

An engine = (architecture x precision x request shape).  Twelve engines
mirror the paper's twelve MLPerf engine variants; quantized variants play
the role of the paper's quantized MobileNets.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

from repro_torch.configs.registry import ARCHS, get_config


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    arch: str
    precision: str = "bf16"          # bf16 | int8
    prefill_len: int = 512           # tokens of prompt per query
    decode_len: int = 128            # generated tokens per query
    microbatch: int = 8              # requests served together

    @property
    def bytes_per_param(self) -> float:
        return 1.0 if self.precision == "int8" else 2.0

    @property
    def cfg(self):
        return get_config(self.arch)


def default_engines() -> Dict[str, EngineSpec]:
    engines = [
        EngineSpec("danube-1.8b/bf16", "h2o-danube-1.8b"),
        EngineSpec("gemma-2b/bf16", "gemma-2b"),
        EngineSpec("gemma-2b/int8", "gemma-2b", precision="int8"),
        EngineSpec("qwen3-32b/bf16", "qwen3-32b", microbatch=4),
        EngineSpec("qwen3-4b/bf16", "qwen3-4b"),
        EngineSpec("qwen3-4b/int8", "qwen3-4b", precision="int8"),
        EngineSpec("rwkv6-1.6b/bf16", "rwkv6-1.6b"),
        EngineSpec("llama32-vision/bf16", "llama-3.2-vision-11b",
                   microbatch=4),
        EngineSpec("phi3.5-moe/bf16", "phi3.5-moe-42b-a6.6b", microbatch=4),
        EngineSpec("deepseek-v2/int8", "deepseek-v2-236b", precision="int8",
                   microbatch=2),
        EngineSpec("hymba-1.5b/bf16", "hymba-1.5b"),
        EngineSpec("seamless-m4t/bf16", "seamless-m4t-medium",
                   prefill_len=1024, decode_len=64),
    ]
    return {e.name: e for e in engines}


@functools.lru_cache(maxsize=None)
def engine_catalogue() -> Dict[str, EngineSpec]:
    """Cached ``default_engines()`` for per-tick / per-arrival hot paths
    (scheduler streaming gates).  Treat the returned dict as read-only —
    callers that want their own copy use ``default_engines()``."""
    return default_engines()
