"""matmul_pipe — PipeCNN's multi-mode compute engine in FC mode.

``y = relu?(x @ w + b)`` in fp32, in bf16 (bf16 x, w and b, an fp32
accumulator, bf16 y), or in int8 (``scale=`` given: int8 x and w, an
int32 accumulator, and the requantize -> bias -> ReLU -> round epilogue).
Kernel: ``csrc/matmul_pipe.cu``, which replaces the TPU kernel
``src/repro/kernels/matmul_pipe.py:matmul_pipe`` (all three modes). At
the serving shape (M = the micro-batch) it is bound by the device-memory
bytes of ``w``; a block holds every batch row against its weight slab so
each weight is read once (the paper's batched-FC reuse). Every mode
streams ``w`` through a ``cp.async`` ring, fp32 into FFMA, bf16 and int8
into the tensor cores (``mma.sync``), with the reduction split over the
blocks of a thread-block cluster (:func:`fc_split` picks the split, one
rule a mode). See the source for the design. The plain version,
:func:`matmul_pipe_plain`, computes each mode as the kernel rounds it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import sm_count
from repro_torch.kernels.ref import float_dtypes, matmul_pipe_ref
from repro_torch.quant.ref import fc_int8_ref

__all__ = ["fc_chunk", "fc_split", "matmul_pipe", "matmul_pipe_plain"]

# each split-K kernel's features a cluster (csrc TNF), largest first
FC_FEATURES = {torch.bfloat16: (64, 32), torch.float32: (128, 64, 32),
               torch.int8: (128, 32)}
FC_RANKS = 8             # the most blocks a cluster: the portable size
# fc_split's rule a mode: the feature tiles it tries, in order, and the
# blocks it wants on each SM (tile_sweep.py measured both on an H100; int8
# wants about 1.4: 192 blocks, 128 features x 6 ranks, were the fastest of
# its splits at VGG-16 fc6)
FC_RULE = {torch.bfloat16: ((64, 32), 2), torch.float32: ((64, 32), 1),
           torch.int8: ((128, 32), 1.4)}


def fc_chunk(dtype: torch.dtype, tnf: int) -> int:
    """The reduction chunk of the ``dtype`` kernel at ``tnf`` features:
    64 k in bf16 (csrc BKW); 8 KB of w in fp32 (2048 / tnf k) and int8
    (8192 / tnf k)."""
    return 64 if dtype == torch.bfloat16 else 8192 // (tnf * dtype.itemsize)


@functools.lru_cache(maxsize=None)
def fc_split(dtype: torch.dtype, M: int, K: int, N: int,
             sms: int) -> Tuple[int, int]:
    """The split of one launch in mode ``dtype`` (w's dtype: fp32, bf16
    or int8), ``(tnf, ranks)``: each cluster of ``ranks`` blocks owns
    ``tnf`` output features and 8 rows of x, and its blocks split K. From
    :data:`FC_RULE`'s tiles for the mode, the first that gives ``per_sm``
    blocks an SM at 8 ranks, else the last (fc8); ranks the fewest that
    give ``per_sm`` blocks an SM, at most 8 and at most one a chunk of K.
    Memoised."""
    features, per_sm = FC_RULE[dtype]
    want = math.ceil(per_sm * sms)          # blocks
    rows = -(-M // 8)
    tnf = next((f for f in features
                if -(-N // f) * rows * FC_RANKS >= want), features[-1])
    tiles = -(-N // tnf) * rows
    ranks = max(1, min(FC_RANKS, -(-K // fc_chunk(dtype, tnf)),
                       -(-want // tiles)))
    return tnf, ranks


def matmul_pipe_plain(x, w, b, *, relu=False, scale=None, out_scale=None):
    """The plain version of each mode: the exact fp32 oracle, which in bf16
    sums in fp32 and rounds once to bf16, as the kernel does; or with
    ``scale`` the exact-int oracle of the int8 mode."""
    if scale is not None:
        return fc_int8_ref(x, w, b, scale, relu=relu, out_scale=out_scale)
    float_dtypes("matmul_pipe", x, w, b)
    return matmul_pipe_ref(x, w, b, relu=relu)


_FLOAT_ENTRY = {torch.float32: "matmul_pipe_f32",
                torch.bfloat16: "matmul_pipe_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    from repro_torch.kernels import build
    fn = getattr(build.load("matmul_pipe"), name)
    if name == "matmul_pipe_s8":    # out_s8, out_scale, (M, K, N, relu), split
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float] \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    else:                       # (M, K, N, relu) and the split (tnf, ranks)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_pipe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                relu: bool = False, scale: Optional[torch.Tensor] = None,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """y = relu(x @ w + b). x (M, K); w (K, N); b (N,).

    x, w and b all fp32 or all bf16 (y in their dtype); or the int8 mode:
    ``scale`` ((N,) fp32, s_x * s_w[n]) given, x and w int8;
    ``out_scale`` (a float) selects int8 output quantized by that step,
    None fp32 output. A CPU tensor runs :func:`matmul_pipe_plain`; a CUDA
    tensor launches the kernel (counted in ``matmul_pipe.launches``, fp32,
    ``matmul_pipe.launches_bf16`` or ``matmul_pipe.launches_s8``, int8) or
    raises."""
    if x.device.type == "cpu":
        return matmul_pipe_plain(x, w, b, relu=relu, scale=scale,
                                 out_scale=out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_pipe: unsupported device {x.device}")
    M, K = x.shape
    if w.shape[0] != K or b.shape != (w.shape[1],):
        raise ValueError(f"matmul_pipe: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)} disagree")
    int8 = scale is not None
    if not int8:
        float_dtypes("matmul_pipe", x, w, b)
    want = (("x", x, torch.int8), ("w", w, torch.int8), ("b", b, torch.float32),
            ("scale", scale, torch.float32)) if int8 else (
        ("x", x, x.dtype), ("w", w, x.dtype), ("b", b, x.dtype))
    for name, t, dtype in want:
        if (t.device != x.device or t.dtype != dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"matmul_pipe: {name} must be a contiguous, 16-byte aligned "
                f"{dtype} tensor on {x.device}, got {t.dtype} on {t.device}")
    N = w.shape[1]
    if int8 and scale.shape != (N,):
        raise ValueError(f"matmul_pipe: scale {tuple(scale.shape)} for "
                         f"{N} output features")
    out_s8 = int8 and out_scale is not None
    y = torch.empty((M, N), device=x.device,
                    dtype=torch.int8 if out_s8 else
                    torch.float32 if int8 else x.dtype)
    if y.numel() == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    split = fc_split(w.dtype, M, K, N, sm_count(x.device))
    if int8:
        err = _entry("matmul_pipe_s8")(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            y.data_ptr(), int(out_s8), float(out_scale) if out_s8 else 1.0,
            M, K, N, int(relu), *split, stream)
    else:
        err = _entry(_FLOAT_ENTRY[x.dtype])(x.data_ptr(), w.data_ptr(),
                                            b.data_ptr(), y.data_ptr(), M, K,
                                            N, int(relu), *split, stream)
    if err:
        raise RuntimeError(
            f"matmul_pipe kernel launch failed: CUDA error {err}")
    if int8:
        matmul_pipe.launches_s8 += 1
    elif x.dtype == torch.bfloat16:
        matmul_pipe.launches_bf16 += 1
    else:
        matmul_pipe.launches += 1
    return y


matmul_pipe.launches = 0         # fp32 launches
matmul_pipe.launches_bf16 = 0    # bf16 launches
matmul_pipe.launches_s8 = 0      # int8 launches
