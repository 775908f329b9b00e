"""Training on the port: the synthetic data pipeline (a copy), AdamW, the
train step and checkpoints, the counterparts of the JAX package's
``repro.training``."""
