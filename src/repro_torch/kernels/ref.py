"""Exact plain-PyTorch oracles of the fused kernels (the ground truth).

Each function computes what one JAX oracle in ``repro/kernels/ref.py``
computes, on the same layouts: NHWC activations, HWIO conv weights,
(K, N) FC weights. ``use_kernels=False`` runs the model on these.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.lrn_pwl import LRN_ALPHA, LRN_BETA, LRN_K, LRN_N


def conv_pipe_ref(x, w, b, *, stride=1, pad=0, relu=True, pool=None,
                  pool_k=2, pool_s=2, groups=1):
    """conv + bias + ReLU + pool, grouped. x (B,H,W,C); w (KH,KW,C/G,M)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=pad, groups=groups)
    out = out.permute(0, 2, 3, 1) + b
    if relu:
        out = torch.clamp_min(out, 0.0)
    if pool is not None:
        out = pool_ref(out, pool, pool_k, pool_s)
    return out.contiguous()


def pool_ref(x, pool="max", k=2, s=2):
    """VALID k x k / s pooling over H and W of an NHWC tensor; max also
    takes integer codes (max commutes with the int8 map). avg sums each
    window element by element in row-major order and divides by a k*k
    tensor, as the kernels do, so the sum rounds the same way."""
    if pool == "max":
        win = x.unfold(1, k, s).unfold(2, k, s)    # (B, PH, PW, C, k, k)
        return win.amax(dim=(-2, -1)).contiguous()
    if not x.is_floating_point():
        raise NotImplementedError(
            "avg-pool on integer codes needs a requantize; dequantize first")
    ph = (x.shape[1] - k) // s + 1
    pw = (x.shape[2] - k) // s + 1
    out = None
    for i in range(k):
        for j in range(k):
            sl = x[:, i:i + (ph - 1) * s + 1:s, j:j + (pw - 1) * s + 1:s]
            out = sl if out is None else out + sl
    return (out / torch.tensor(float(k * k), dtype=x.dtype,
                               device=x.device)).contiguous()


def lrn_ref(x, *, n=LRN_N, k=LRN_K, alpha=LRN_ALPHA, beta=LRN_BETA):
    """Exact cross-channel LRN (the function the PWL kernel approximates)."""
    xf = x.float()
    sq = xf * xf
    acc = sq
    for d in range(1, n // 2 + 1):
        acc = acc + F.pad(sq[..., d:], (0, d))
        acc = acc + F.pad(sq[..., :-d], (d, 0))
    z = k + (alpha / n) * acc
    return (xf * z ** (-beta)).to(x.dtype)


def matmul_pipe_ref(x, w, b=None, *, relu=False):
    """relu?(x @ w + b) in fp32. x (M, K); w (K, N); b (N,)."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)
