"""Shared building blocks of the LM side, copies of the JAX package's
``models/layers.py``: statistics, rotary angles and the cross entropy in
fp32 whatever the activation dtype. The JAX ``scan_or_unroll`` has no
copy: the port's structural loops are Python loops."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import chunk, shard, take_last


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initializers (fan-in scaled normal), drawn from an explicit generator
# ---------------------------------------------------------------------------

def dense_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device=None,
               scale: float = 1.0) -> torch.Tensor:
    """Normal / sqrt(fan_in) times ``scale``, drawn in fp32 on the
    generator's device, then cast and moved to ``device``. ``fan_in`` is
    ``shape[-2]`` (the JAX rule: a stacked ``(E, d, f)`` expert weight is
    scaled by ``d``). On the ``meta`` device nothing is drawn."""
    shape = tuple(shape)
    device = generator.device if device is None else torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    t = torch.randn(shape, generator=generator, device=generator.device)
    return (t * (scale / math.sqrt(fan_in))).to(device=device, dtype=dtype)


def embed_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device=None) -> torch.Tensor:
    """Normal times 0.02, drawn in fp32, then cast (nothing on ``meta``)."""
    shape = tuple(shape)
    device = generator.device if device is None else torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, device=generator.device)
    return (t * 0.02).to(device=device, dtype=dtype)

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics regardless of activation dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Made on ``device``: a copy from the host would wait for the stream
    on every call."""
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (half,)
    angles = positions[..., :, None].float() * freqs            # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]                    # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(gate_up: torch.Tensor) -> torch.Tensor:
    """Fused gate+up projection output -> SiLU(gate) * up."""
    gate, up = chunk(gate_up, 2, -1)
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Cross entropy (fp32 math)
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL. logits (..., V) any dtype; labels (...) integers.

    In fp32, with the row max detached (JAX's ``stop_gradient``). The gold
    logit is a ``gather`` of the shifted logits: JAX's ``iota == label``
    masked sum adds that one element to zeros, so both give the same value
    and the same gradient, and the gather builds no vocabulary-sized int
    and fp32 temporaries (5 GB each at Qwen3-8B's 152,064 padded columns
    and 8192 tokens). On vocab-sharded logits (the dry run) the gather is
    ``sharding.take_last``'s, JAX's local pick and one all-reduce.
    """
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    # the dry run: the shifted logits and each token's loss, and their
    # gradients, cut as JAX's are (DTensor would cut the gradients' sequence
    # dim over "model", and every product behind them after it); each
    # token's two sums over the cut vocab all-reduced where they are made,
    # as GSPMD does (DTensor would reduce-scatter them onto the sequence)
    shifted = shard(logits - m, "batch", "seq", "vocab")
    lse = torch.log(shard(torch.exp(shifted).sum(dim=-1), "batch", "seq"))
    gold = shard(take_last(shifted, labels), "batch", "seq")
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
