"""conv_pipe — the PipeCNN pipeline as one fused CUDA kernel, fp32.

conv + bias + ReLU (+ max/avg pool), grouped, in one launch per fusion
group. Kernel: ``csrc/conv_pipe.cu``, which replaces the TPU kernel
``src/repro/kernels/conv_pipe.py:conv_pipe`` (fp32 mode). It is bound by
fp32 operations on the CUDA cores; it computes an implicit GEMM with the
bias/ReLU/pool epilogue on a tile staged in shared memory, so the
unpooled activation never reaches device memory. See the source for the
design. The plain version is the exact oracle
:func:`repro_torch.kernels.ref.conv_pipe_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import conv_pipe_ref as conv_pipe_plain

__all__ = ["conv_pipe", "conv_pipe_plain", "pool_tile"]

TILE_POSITIONS = 64          # conv positions a block computes (csrc TP)
_POOL_CODES = {None: 0, "max": 1, "avg": 2}


def pool_tile(ph: int, pw: int, pool_k: int, pool_s: int) -> Tuple[int, int]:
    """Pooled outputs per block, ``(tph, tpw)``, for a ``ph`` x ``pw``
    pooled map: the conv patch ``((tph-1)*s+k) x ((tpw-1)*s+k)`` must fit
    the kernel's TILE_POSITIONS rows, and every block costs the same, so
    take the fewest blocks (then the smallest patch)."""
    best = None
    for tph in range(1, ph + 1):
        for tpw in range(1, pw + 1):
            area = ((tph - 1) * pool_s + pool_k) * ((tpw - 1) * pool_s + pool_k)
            if area > TILE_POSITIONS:
                continue
            key = (-(-ph // tph) * -(-pw // tpw), area, tph, tpw)
            best = key if best is None or key < best else best
    if best is None:
        raise ValueError(f"conv_pipe: a {pool_k}x{pool_k} pool window does "
                         f"not fit the {TILE_POSITIONS}-position conv tile")
    return best[2], best[3]


@functools.lru_cache(maxsize=None)
def _entry():
    from repro_torch.kernels import build
    fn = build.load("conv_pipe").conv_pipe_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_pipe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              stride: int = 1, pad: int = 0, relu: bool = True,
              pool: Optional[str] = None, pool_k: int = 2, pool_s: int = 2,
              groups: int = 1) -> torch.Tensor:
    """Fused conv(+bias)(+ReLU)(+pool). x (B,H,W,C); w (KH,KW,C/G,M); b (M,).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``conv_pipe.launches``) or raises."""
    if x.device.type == "cpu":
        return conv_pipe_plain(x, w, b, stride=stride, pad=pad, relu=relu,
                               pool=pool, pool_k=pool_k, pool_s=pool_s,
                               groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"conv_pipe: unsupported device {x.device}")
    if pool not in _POOL_CODES:
        raise ValueError(f"conv_pipe: pool={pool!r}: None, 'max' or 'avg'")
    B, H, W, C = x.shape
    KH, KW, cg, M = w.shape
    if C % groups or M % groups or cg * groups != C or b.shape != (M,):
        raise ValueError(
            f"conv_pipe: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)} disagree for groups={groups}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(
                f"conv_pipe: {name} must be a contiguous float32 tensor on "
                f"{x.device}, got {t.dtype} on {t.device}")
    OH = (H + 2 * pad - KH) // stride + 1
    OW = (W + 2 * pad - KW) // stride + 1
    ph, pw = (OH, OW) if pool is None else (
        (OH - pool_k) // pool_s + 1, (OW - pool_k) // pool_s + 1)
    if min(OH, OW, ph, pw) <= 0:
        raise ValueError(f"conv_pipe: empty output for x {tuple(x.shape)}, "
                         f"kernel {KH}x{KW}, stride {stride}, pad {pad}, "
                         f"pool {pool}")
    pk, ps, tph, tpw = (1, 1, 1, 1) if pool is None else (
        pool_k, pool_s, *pool_tile(ph, pw, pool_k, pool_s))
    out = torch.empty((B, ph, pw, M), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    err = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                   B, H, W, C, KH, KW, M, groups, stride, pad, int(relu),
                   _POOL_CODES[pool], pk, ps, tph, tpw,
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"conv_pipe kernel launch failed: CUDA error {err}")
    conv_pipe.launches += 1
    return out


conv_pipe.launches = 0
