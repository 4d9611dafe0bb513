"""InternLM2-20B — dense GQA transformer.

[arXiv:2403.17297; hf]. 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.
The same record as the JAX package's ``configs/internlm2_20b.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92544,
    rope_theta=1e6,
)
