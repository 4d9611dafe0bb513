"""Zamba2-1.2B — Mamba2 backbone with a SHARED attention block interleaved.

[arXiv:2411.15242; hf]. 38L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=32000, ssm_state=64. One attention+MLP block's parameters are shared
across all its applications (every 6th layer), Zamba2's hallmark.
Sub-quadratic backbone => runs long_500k.
The same record as the JAX package's ``configs/zamba2_1p2b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    attn_every=6,
    rope_theta=1e4,
)
