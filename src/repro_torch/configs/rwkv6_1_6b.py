# Port of repro/configs/rwkv6_1_6b.py: the same data, imports rewritten to repro_torch.
"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay. [arXiv:2404.05892]"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / rwkv_head_dim
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    ssm=SSMConfig(rwkv_head_dim=64, lora_rank=64),
)
