# Port of repro/configs/deepseek_v2_236b.py: the same data, imports rewritten to repro_torch.
"""deepseek-v2-236b — MLA (kv_lora=512), 2 shared + 160 routed top-6.

Per the assignment config all 60 layers are MoE (the real model's dense first
layer is folded into the uniform stack — noted in DESIGN.md). [arXiv:2405.04434]
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=1536,
    vocab=102400,
    act="silu",
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
)
