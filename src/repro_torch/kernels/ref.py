"""Exact plain-PyTorch oracles of the fused kernels (the ground truth).

Each function computes what one JAX oracle in ``repro/kernels/ref.py``
computes, on the same layouts: NHWC activations, HWIO conv weights,
(K, N) FC weights, (B, H, S, D) attention heads and (B, S, HKV, D) KV
caches. ``use_kernels=False`` runs the model on these.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.lrn_pwl import LRN_ALPHA, LRN_BETA, LRN_K, LRN_N


def float_dtypes(name: str, *ts) -> None:
    """Refuse float operands of mixed dtypes, as the JAX oracles do: all
    float32 or all bfloat16."""
    dts = [t.dtype for t in ts]
    if dts[0] not in (torch.float32, torch.bfloat16) or len(set(dts)) > 1:
        raise ValueError(f"{name}: operands must be all float32 or all "
                         f"bfloat16, got {', '.join(map(str, dts))}")


def conv_pipe_ref(x, w, b, *, stride=1, pad=0, relu=True, pool=None,
                  pool_k=2, pool_s=2, groups=1):
    """conv + bias + ReLU + pool, grouped. x (B,H,W,C); w (KH,KW,C/G,M).
    In x's dtype throughout: in bf16 the conv rounds to bf16, then ``+ b``
    rounds again, as the JAX oracle computes."""
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
    """Exact cross-channel LRN (the function the PWL kernel approximates),
    in fp32, cast to x's dtype."""
    xf = x.float()
    sq = xf * xf
    acc = sq
    for d in range(1, n // 2 + 1):
        acc = acc + F.pad(sq[..., d:], (0, d))
        acc = acc + F.pad(sq[..., :-d], (d, 0))
    z = k + (alpha / n) * acc
    return (xf * z ** (-beta)).to(x.dtype)


def matmul_pipe_ref(x, w, b=None, *, relu=False):
    """relu?(x @ w + b) in fp32, cast to x's dtype. x (M, K); w (K, N);
    b (N,)."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def flash_attention_ref(q, k, v):
    """Causal MHA oracle, fp32 softmax. q/k/v (B, H, S, D).

    The mask is ``tril(k=Sk-Sq)``, as in the JAX oracle; the kernel masks
    ``q_pos >= k_pos``, and the two agree only at Sq == Sk."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(D)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril(
        Sk - Sq)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, new_k, new_v, pos):
    """Oracle of the decode kernel (update, then attend), functional: the
    caches given are not written. q (B, HKV, G, D); caches (B, S, HKV, D);
    new_k/v (B, HKV, D); pos a scalar (int or 0-d tensor).
    Returns (o (B, HKV, G, D), k_cache', v_cache')."""
    S, D = k_cache.shape[1], k_cache.shape[3]
    slots = torch.arange(S, device=q.device)
    at = (slots == pos)[None, :, None, None]
    ck = torch.where(at, new_k[:, None], k_cache)
    cv = torch.where(at, new_v[:, None], v_cache)
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), ck.float()) / math.sqrt(D)
    s = torch.where((slots <= pos)[None, None, None], s,
                    torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, cv.float())
    return o.to(q.dtype), ck, cv
