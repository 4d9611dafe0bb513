"""Kernel dispatch of the model: fused kernels or the exact oracles.

``use_kernels`` mirrors the JAX package's ``use_pallas``: True runs the
fused kernels (on a CUDA tensor the hand-written kernel, on a CPU tensor
its plain version), False the exact oracles of :mod:`.ref` and
:mod:`repro_torch.quant.ref` (for LRN the exact power, not the PWL
approximation; for attention the JAX oracle with its ``tril`` mask).
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.conv_pipe import conv_pipe
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lrn_pwl import lrn_pwl
from repro_torch.kernels.matmul_pipe import matmul_pipe
from repro_torch.quant import ref as quant_ref

__all__ = ["attention", "fc", "fc_q", "fused_conv", "fused_conv_q", "lrn"]


def fused_conv(x, w, b, *, stride=1, pad=0, relu=True, pool=None, pool_k=2,
               pool_s=2, groups=1, use_kernels=True, tile=None):
    """Fused conv(+bias)(+ReLU)(+pool), grouped. NHWC x HWIO. ``tile``
    (a compiled plan's (tp, tn, tph, tpw)) pins the kernel's tile; the
    oracle takes none."""
    kw = dict(stride=stride, pad=pad, relu=relu, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups)
    if use_kernels:
        return conv_pipe(x, w, b, tile=tile, **kw)
    return ref.conv_pipe_ref(x, w, b, **kw)


def fused_conv_q(x_q, w_q, b, scale, *, out_scale=None, stride=1, pad=0,
                 relu=True, pool=None, pool_k=2, pool_s=2, groups=1,
                 use_kernels=True, tile=None):
    """int8 fused conv, the fixed-point twin of :func:`fused_conv`: int8
    x_q/w_q, fp32 b, ``scale`` the (M,) s_x*s_w requantize multiplier,
    ``out_scale`` the output step (None: fp32 output). The oracle is the
    exact int32 reference, bit-equal to the kernel."""
    kw = dict(stride=stride, pad=pad, relu=relu, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups, out_scale=out_scale)
    if use_kernels:
        return conv_pipe(x_q, w_q, b, scale=scale, tile=tile, **kw)
    return quant_ref.conv_int8_ref(x_q, w_q, b, scale, **kw)


def lrn(x, *, use_kernels=True):
    """Cross-channel LRN: the PWL kernel, or the exact power."""
    return lrn_pwl(x) if use_kernels else ref.lrn_ref(x)


def fc(x, w, b=None, *, relu=False, use_kernels=True, split=None):
    """Batched FC; ``b=None`` is zeros, as in the JAX package. ``split``
    (a compiled plan's (tnf, ranks)) pins the kernel's split."""
    if use_kernels:
        return matmul_pipe(x, w, b, relu=relu, split=split)
    return ref.matmul_pipe_ref(x, w, b, relu=relu)


def fc_q(x_q, w_q, b, scale, *, relu=False, out_scale=None,
         use_kernels=True, split=None):
    """int8 batched FC: int8 x/w, int32 accumulation, requantize epilogue;
    the oracle is the exact int32 reference, bit-equal to the kernel."""
    if use_kernels:
        return matmul_pipe(x_q, w_q, b, scale=scale, relu=relu,
                           out_scale=out_scale, split=split)
    return quant_ref.fc_int8_ref(x_q, w_q, b, scale, relu=relu,
                                 out_scale=out_scale)


def attention(q, k, v, *, use_kernels=True):
    """Causal attention, GQA-aware: q (B, Hq, S, D), k/v (B, Hkv, S, D).

    Query head ``h`` attends with KV head ``h // (Hq // Hkv)``, the order
    the JAX package's ``jnp.repeat(k, g, axis=1)`` gives. The kernel reads
    that head in place; ``use_kernels=False`` repeats the heads and runs
    the oracle ``ref.flash_attention_ref``, as JAX does (the kernel's
    plain version). The kernel masks ``k_pos > q_pos`` and the oracle
    ``tril(k=Sk-Sq)``: they agree at Sq == Sk, the only case the JAX
    package runs and the only one the kernel takes."""
    if use_kernels:
        return flash_attention(q, k, v)
    return flash_attention_plain(q, k, v)
