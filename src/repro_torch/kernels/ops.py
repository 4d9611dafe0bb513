"""Kernel dispatch of the model: fused kernels or the exact oracles.

``use_kernels`` mirrors the JAX package's ``use_pallas``: True runs the
fused kernels (on a CUDA tensor the hand-written kernel, on a CPU tensor
its plain version), False the exact oracles of :mod:`.ref` (for LRN the
exact power, not the PWL approximation).
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.conv_pipe import conv_pipe
from repro_torch.kernels.lrn_pwl import lrn_pwl
from repro_torch.kernels.matmul_pipe import matmul_pipe

__all__ = ["fc", "fused_conv", "lrn"]


def fused_conv(x, w, b, *, stride=1, pad=0, relu=True, pool=None, pool_k=2,
               pool_s=2, groups=1, use_kernels=True):
    """Fused conv(+bias)(+ReLU)(+pool), grouped. NHWC x HWIO."""
    fn = conv_pipe if use_kernels else ref.conv_pipe_ref
    return fn(x, w, b, stride=stride, pad=pad, relu=relu, pool=pool,
              pool_k=pool_k, pool_s=pool_s, groups=groups)


def lrn(x, *, use_kernels=True):
    """Cross-channel LRN: the PWL kernel, or the exact power."""
    return lrn_pwl(x) if use_kernels else ref.lrn_ref(x)


def fc(x, w, b, *, relu=False, use_kernels=True):
    fn = matmul_pipe if use_kernels else ref.matmul_pipe_ref
    return fn(x, w, b, relu=relu)
