# Port of repro/configs/qwen3_32b.py: the same data, imports rewritten to repro_torch.
"""qwen3-32b — dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B family scaling]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    act="silu",
    qk_norm=True,
    rope_theta=1000000.0,
)
