# Port of repro/configs/qwen3_4b.py: the same data, imports rewritten to repro_torch.
"""qwen3-4b — dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B family scaling]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1000000.0,
)
