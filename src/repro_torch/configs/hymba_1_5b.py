# Port of repro/configs/hymba_1_5b.py: the same data, imports rewritten to repro_torch.
"""hymba-1.5b — parallel attention + Mamba heads per layer. [arXiv:2411.13676]

Meta-tokens are omitted (orthogonal to scheduling/serving; noted in DESIGN.md).
SWA on all layers except three global ones, per the paper.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    act="silu",
    sliding_window=1024,
    global_layers=(0, 15, 31),
    ssm=SSMConfig(state_dim=16, d_inner_mult=2, d_conv=4),
)
