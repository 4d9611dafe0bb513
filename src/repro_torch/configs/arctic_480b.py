"""Snowflake Arctic 480B — 128-expert top-2 MoE with a dense residual path.

[hf:Snowflake/snowflake-arctic-base; hf]. 35L d_model=7168 56H (GQA kv=8)
expert d_ff=4864 vocab=32000. The dense residual MLP runs in parallel with
the MoE branch (Arctic's "dense + MoE" hybrid-residual design).

Note: 480B params x (bf16 + AdamW m/v) exceed a 256-chip v5e pod at fp32
optimizer state, so this config keeps m/v in bf16 (see DESIGN.md §5).
The same record as the JAX package's ``configs/arctic_480b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    opt_state_dtype="bfloat16",
    rope_theta=1e6,
)
