"""Qwen3-32B — dense GQA transformer with per-head q/k RMSNorm.

[hf:Qwen/Qwen3-8B; hf]. 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm.
The same record as the JAX package's ``configs/qwen3_32b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    d_head=128,                 # Qwen3 uses d_head=128 (not d_model/n_heads=80)
    rope_theta=1e6,
)
