"""matmul_pipe — PipeCNN's multi-mode compute engine in FC mode, fp32.

``y = relu?(x @ w + b)``. Kernel: ``csrc/matmul_pipe.cu``, which replaces
the TPU kernel ``src/repro/kernels/matmul_pipe.py:matmul_pipe`` (fp32
mode). At the serving shape (M = the micro-batch) it is bound by the
device-memory bytes of ``w``; a block holds every batch row against its
weight slab so each weight is read once (the paper's batched-FC reuse).
See the source for the design. The plain version is the exact oracle
:func:`repro_torch.kernels.ref.matmul_pipe_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.ref import matmul_pipe_ref as matmul_pipe_plain

__all__ = ["matmul_pipe", "matmul_pipe_plain"]


@functools.lru_cache(maxsize=None)
def _entry():
    from repro_torch.kernels import build
    fn = build.load("matmul_pipe").matmul_pipe_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_pipe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                relu: bool = False) -> torch.Tensor:
    """y = relu(x @ w + b). x (M, K); w (K, N); b (N,); fp32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (counted in ``matmul_pipe.launches``) or raises."""
    if x.device.type == "cpu":
        return matmul_pipe_plain(x, w, b, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_pipe: unsupported device {x.device}")
    M, K = x.shape
    if w.shape[0] != K or b.shape != (w.shape[1],):
        raise ValueError(f"matmul_pipe: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if (t.device != x.device or t.dtype != torch.float32
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"matmul_pipe: {name} must be a contiguous, 16-byte aligned "
                f"float32 tensor on {x.device}, got {t.dtype} on {t.device}")
    N = w.shape[1]
    y = torch.empty((M, N), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    err = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                   M, K, N, int(relu),
                   torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"matmul_pipe kernel launch failed: CUDA error {err}")
    matmul_pipe.launches += 1
    return y


matmul_pipe.launches = 0
