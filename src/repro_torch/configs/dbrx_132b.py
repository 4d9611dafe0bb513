"""DBRX-132B — fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]. 40L d_model=6144 48H (GQA kv=8)
expert d_ff=10752 vocab=100352.
The same record as the JAX package's ``configs/dbrx_132b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    rope_theta=5e5,
)
