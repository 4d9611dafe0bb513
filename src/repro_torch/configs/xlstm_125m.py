"""xLSTM-125M — alternating sLSTM + mLSTM blocks, no FFN (d_ff=0).

[arXiv:2405.04517; unverified]. 12L d_model=768 4H vocab=50304.
Sub-quadratic (recurrent) => runs the long_500k decode shape.
The same record as the JAX package's ``configs/xlstm_125m.py``.
"""
from repro_torch.core.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                     # blocks carry their own up/down projections
    vocab=50304,
    xlstm_slstm_every=2,        # mLSTM / sLSTM alternate 1:1
    ssm_headdim=192,            # d_model / n_heads
)
