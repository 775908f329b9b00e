# Port of repro/configs/llama32_vision_11b.py: the same data, imports rewritten to repro_torch.
"""llama-3.2-vision-11b — decoder backbone with cross-attn image layers.

The modality frontend (ViT encoder + projector) is a STUB per the assignment:
``input_specs()`` provides precomputed patch embeddings [B, 1601, d_model].
[hf:meta-llama/Llama-3.2-11B-Vision]
"""

from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    act="silu",
    rope_theta=500000.0,
    vision=VisionConfig(n_vision_tokens=1601, cross_attn_every=5),
)
