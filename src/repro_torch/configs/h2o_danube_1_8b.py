# Port of repro/configs/h2o_danube_1_8b.py: the same data, imports rewritten to repro_torch.
"""h2o-danube-1.8b — dense, llama+mistral mix, SWA. [arXiv:2401.16818]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    act="silu",
    sliding_window=4096,
    rope_theta=10000.0,
)
