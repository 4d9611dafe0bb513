"""MusicGen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]. 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048. The EnCodec/text-conditioning frontend is a STUB per the
assignment: ``input_specs`` provides precomputed conditioning frame
embeddings prepended to the token stream.
The same record as the JAX package's ``configs/musicgen_medium.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    frontend="frame_embed",
    frontend_len=64,            # 64 conditioning frames prepended
    rope_theta=1e4,
)
