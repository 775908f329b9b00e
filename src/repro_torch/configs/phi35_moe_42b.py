# Port of repro/configs/phi35_moe_42b.py: the same data, imports rewritten to repro_torch.
"""phi3.5-moe-42b-a6.6b — 16 experts, top-2. [hf:microsoft/Phi-3.5-MoE-instruct]"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    act="silu",
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_ff_expert=6400),
)
