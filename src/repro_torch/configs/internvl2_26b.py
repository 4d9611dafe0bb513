"""InternVL2-26B — InternViT-6B frontend (stub) + InternLM2-20B LM backbone.

[arXiv:2404.16821; hf]. 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The ViT frontend is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (B, frontend_len, d_model).
The same record as the JAX package's ``configs/internvl2_26b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    rope_theta=1e6,
    frontend="patch_embed",
    frontend_len=1024,          # 1024 visual patch embeddings prepended
)
