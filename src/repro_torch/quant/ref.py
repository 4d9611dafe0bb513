"""Plain references of the int8 pipeline (the ground truth).

A copy of the JAX package's ``quant/ref.py``:

* :func:`conv_int8_ref` / :func:`fc_int8_ref` -- exact integer math: int8
  operands, an exact int32 accumulator, then the requantize -> bias ->
  ReLU -> pool -> round epilogue the int8 kernel modes fuse. They are the
  plain versions of those modes, which must match them bit for bit.
* :func:`conv_fake_quant_ref` -- fp32 math on fake-quantized operands
  (the QAT-style model of what the int8 pipeline computes).

The accumulator is a float64 product of the int8 codes on either device
(cuDNN and cuBLAS take no int32): every partial sum is an integer below
127^2 * K, far under 2^53 at any layer of the repo (K <= 9216 on AlexNet),
so the float64 sums are exact in any order and cast to int32 unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import pool_ref
from repro_torch.quant.core import as_scale, fake_quant, quantize


def _epilogue(acc_f32, b, *, relu, pool, pool_k, pool_s,
              out_scale: Optional[float]):
    """The shared bias -> ReLU -> pool -> requantize tail (fp32 in, int8
    or fp32 out), each step its own rounding, as in the kernels; the
    result is contiguous, as the kernels' is."""
    y = acc_f32 + b.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    if pool is not None:
        y = pool_ref(y, pool, pool_k, pool_s)
    if out_scale is not None:
        y = quantize(y, out_scale)
    return y.contiguous()


def _conv_int8_acc(x_q, w_q, *, stride=1, pad=0, groups=1) -> torch.Tensor:
    """The exact int32 accumulator of a grouped conv on int8 codes.
    x_q (B,H,W,C) int8 NHWC; w_q (KH,KW,C/G,M) int8 HWIO; -> (B,OH,OW,M)."""
    x = x_q.permute(0, 3, 1, 2).double()
    KH, KW, cg, M = w_q.shape
    B, _, H, W = x.shape
    OH = (H + 2 * pad - KH) // stride + 1
    OW = (W + 2 * pad - KW) // stride + 1
    cols = F.unfold(x, (KH, KW), padding=pad, stride=stride)
    w = w_q.permute(3, 2, 0, 1).double().reshape(groups, M // groups, -1)
    acc = w @ cols.reshape(B, groups, cg * KH * KW, OH * OW)
    return acc.reshape(B, M, OH, OW).permute(0, 2, 3, 1).to(torch.int32)


def conv_int8_ref(x_q, w_q, b, scale, *, stride: int = 1, pad: int = 0,
                  relu: bool = True, pool: Optional[str] = None,
                  pool_k: int = 2, pool_s: int = 2, groups: int = 1,
                  out_scale: Optional[float] = None) -> torch.Tensor:
    """Exact-int oracle of the int8 conv_pipe mode.

    x_q (B,H,W,C) int8; w_q (KH,KW,C/G,M) int8; b (M,) fp32 bias;
    scale (M,) fp32 = s_x * s_w[m]. Returns int8 (requantized by
    ``out_scale``) or fp32 (``out_scale=None``)."""
    acc = _conv_int8_acc(x_q, w_q, stride=stride, pad=pad, groups=groups)
    return _epilogue(acc.float() * scale, b, relu=relu, pool=pool,
                     pool_k=pool_k, pool_s=pool_s, out_scale=out_scale)


def fc_int8_ref(x_q, w_q, b, scale, *, relu: bool = False,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """Exact-int oracle of the int8 matmul_pipe mode.
    x_q (M,K) int8; w_q (K,N) int8; b/scale (N,) fp32."""
    acc = (x_q.double() @ w_q.double()).to(torch.int32)
    return _epilogue(acc.float() * scale, b, relu=relu, pool=None,
                     pool_k=2, pool_s=2, out_scale=out_scale)


def conv_fake_quant_ref(x, w, b, *, x_scale, w_scale, stride: int = 1,
                        pad: int = 0, relu: bool = True,
                        pool: Optional[str] = None, pool_k: int = 2,
                        pool_s: int = 2, groups: int = 1,
                        out_scale: Optional[float] = None) -> torch.Tensor:
    """fp32 conv on fake-quantized operands (the QAT-style reference);
    differs from :func:`conv_int8_ref` only by float summation order."""
    xf = fake_quant(x, x_scale)
    wf = fake_quant(w, as_scale(w_scale, w).reshape(1, 1, 1, -1))
    acc = F.conv2d(xf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1),
                   stride=stride, padding=pad, groups=groups)
    y = _epilogue(acc.permute(0, 2, 3, 1), b, relu=relu, pool=pool,
                  pool_k=pool_k, pool_s=pool_s, out_scale=None)
    return fake_quant(y, out_scale) if out_scale is not None else y
