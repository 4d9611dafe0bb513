"""Minitron-4B — width/depth-pruned Nemotron-4.

[arXiv:2407.14679; hf]. 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 (the 256k vocab makes the embedding/logit GEMMs the
FC-bandwidth case PipeCNN batches for).
The same record as the JAX package's ``configs/minitron_4b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256000,
    rope_theta=1e4,
)
