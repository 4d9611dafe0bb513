"""Symmetric int8 quantization primitives of the port.

A copy of the JAX package's ``quant/core.py``: the int8 primitives of the
CNN path, and the block-granular variants the gradient compression
(``optim/compress.py``) sends. Scheme: symmetric (zero point 0),
round-half-to-even, clip to [-127, 127], so zero padding contributes
exactly zero to an int32 accumulator.

Every division by a scale divides by a float32 *tensor on the input's
device*, never by a Python float: on a CUDA tensor PyTorch computes
``x / python_float`` as ``x * (1 / s)``, which differs from the true
quotient in the last bit for about one input in eleven and so flips
int8 codes at rounding ties. The kernels' epilogues divide with
``__fdiv_rn``; this keeps the plain versions bit-equal to them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

QMAX = 127                      # int8 symmetric range [-127, 127]
_EPS = 1e-12                    # guards all-zero tensors (scale stays finite)


def as_scale(scale, like: torch.Tensor) -> torch.Tensor:
    """``scale`` (a Python number or a tensor) as a float32 tensor on the
    device of ``like``, for exact elementwise division and products. A
    number is filled in on the device: a host-to-device copy of it would
    wait for the stream, on every call of the forward."""
    if isinstance(scale, (int, float)):
        return torch.full((), scale, dtype=torch.float32, device=like.device)
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


def abs_max_scale(x: torch.Tensor, axis=None, *, keepdims: bool = False
                  ) -> torch.Tensor:
    """scale = max|x| / 127 over ``axis`` (None = per-tensor).

    ``axis=(0, 1, 2)`` on an HWIO conv weight gives the per-output-channel
    scales of the int8 conv path."""
    a = x.float().abs()
    amax = a.amax() if axis is None else a.amax(dim=axis, keepdim=keepdims)
    amax = torch.clamp_min(amax, _EPS)
    return amax / as_scale(QMAX, amax)


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """x -> int8 codes: clip(round(x / scale), -127, 127).

    ``scale`` broadcasts (a float per tensor, or a trailing-axis vector
    per channel). Divide, round half to even, clip: the formula the
    kernels' requantize epilogues apply, so the two agree bit for bit."""
    q = torch.round(x.float() / as_scale(scale, x))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize(q: torch.Tensor, scale) -> torch.Tensor:
    """int8 codes -> fp32: q * scale (broadcasting like :func:`quantize`)."""
    return q.float() * as_scale(scale, q)


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Quantize-dequantize in fp32: the value the int8 pipeline
    represents for ``x``."""
    return dequantize(quantize(x, scale), scale)


def quantize_channelwise(w: torch.Tensor, axis: int = -1
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 weights: ``(w_q, scales)`` with one
    scale per slice of ``axis`` (the output-feature axis of an HWIO conv
    or a (K, N) fc weight)."""
    axis = axis % w.dim()
    red = tuple(a for a in range(w.dim()) if a != axis)
    scale = abs_max_scale(w, axis=red, keepdims=True)
    return quantize(w, scale), scale.reshape(-1)


# ---------------------------------------------------------------------------
# block-granular variants (the gradient-compression payload format)
# ---------------------------------------------------------------------------

def quantize_blocks(x: torch.Tensor, block: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flatten to (n_blocks, block) and quantize with one scale per block.

    Zero-pads the tail block; returns ``(q (n_blocks, block) int8,
    scale (n_blocks, 1) fp32)``, the payload format of the compressed
    gradient all-reduce (``optim.compress``)."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.shape[0]) % block))
    blocks = flat.reshape(-1, block)
    scale = abs_max_scale(blocks, axis=1, keepdims=True)
    return quantize(blocks, scale), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      shape) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks` (drops the tail padding)."""
    n = math.prod(shape)
    return dequantize(q, scale).reshape(-1)[:n].reshape(shape)
