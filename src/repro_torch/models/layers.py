"""Shared building blocks of the LM side, copies of the JAX package's
``models/layers.py``: statistics and rotary angles in fp32 whatever the
activation dtype."""
from __future__ import annotations

import torch

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics regardless of activation dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32)
                            / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta).to(x.device)         # (half,)
    angles = positions[..., :, None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
