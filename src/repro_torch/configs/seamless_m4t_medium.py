# Port of repro/configs/seamless_m4t_medium.py: the same data, imports rewritten to repro_torch.
"""seamless-m4t-medium — encoder-decoder, multimodal. [arXiv:2308.11596]

The speech frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings [B, S, d_model] for the encoder.
"""

from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,                 # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    act="gelu",
    encdec=EncDecConfig(n_enc_layers=12),
)
