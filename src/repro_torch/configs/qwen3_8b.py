"""Qwen3-8B — dense GQA transformer with per-head q/k RMSNorm.

[hf:Qwen/Qwen3-8B; hf]. 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. The same record as the JAX package's
``configs/qwen3_8b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    d_head=128,
    rope_theta=1e6,
)
