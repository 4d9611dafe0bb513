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

__all__ = ["fc_chunk", "fc_smem", "fc_split", "matmul_pipe",
           "matmul_pipe_plain", "split_problem"]

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
# The dynamic shared memory a block requests, bytes: each instantiation's
# SMEM constexpr in csrc/matmul_pipe.cu (FcF32Tile, FcTile, FcS8Tile), by
# mode and features; held equal to the kernels' own (matmul_pipe_smem in
# the library) by chip_smoke.py and tests/test_torch_cuda.py.
FC_SMEM = {torch.float32: {128: 36352, 64: 39424, 32: 45568},
           torch.bfloat16: {64: 41472, 32: 25088},
           torch.int8: {128: 39424, 32: 57856}}


def fc_chunk(dtype: torch.dtype, tnf: int) -> int:
    """The reduction chunk of the ``dtype`` kernel at ``tnf`` features:
    64 k in bf16 (csrc BKW); 8 KB of w in fp32 (2048 / tnf k) and int8
    (8192 / tnf k)."""
    return 64 if dtype == torch.bfloat16 else 8192 // (tnf * dtype.itemsize)


def fc_smem(dtype: torch.dtype, tnf: int) -> int:
    """The shared memory (bytes) a block of the ``dtype`` kernel at ``tnf``
    features requests; 0 where none is instantiated."""
    return FC_SMEM.get(dtype, {}).get(tnf, 0)


def library_smem(dtype: torch.dtype, tnf: int) -> int:
    """The shared memory the built kernel itself requests at ``tnf``
    features (``matmul_pipe_smem`` in the library; -1 where none is
    instantiated): what :data:`FC_SMEM` is held against. Builds the
    library."""
    from repro_torch.kernels import build
    fn = build.load("matmul_pipe").matmul_pipe_smem
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    mode = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[dtype]
    return fn(mode, tnf)


def split_problem(split, dtype: torch.dtype, K: int,
                  smem_budget: int) -> Optional[str]:
    """Why the kernel cannot launch ``split`` = (tnf, ranks) at reduction
    depth ``K``, or None where it can: an instantiated feature tile whose
    shared memory fits ``smem_budget``, and 1 to 8 ranks (the portable
    cluster size), at most one a chunk of K (:func:`fc_chunk`)."""
    try:
        tnf, ranks = (int(v) for v in split)
    except (TypeError, ValueError):
        return f"split {split!r} is not (tnf, ranks)"
    smem = fc_smem(dtype, tnf)
    if not smem:
        return (f"no {dtype} kernel is instantiated at {tnf} features: "
                f"{FC_FEATURES.get(dtype)}")
    if smem > smem_budget:
        return (f"{tnf} features need {smem} B of shared memory, over the "
                f"budget of {smem_budget} B")
    chunks = -(-K // fc_chunk(dtype, tnf))
    if not 1 <= ranks <= min(FC_RANKS, chunks):
        return (f"{ranks} ranks: 1 to {FC_RANKS} a cluster and at most one "
                f"a chunk of K ({chunks} chunks of "
                f"{fc_chunk(dtype, tnf)} at K {K})")
    return None


@functools.lru_cache(maxsize=None)
def _split_error(split, dtype, K, device) -> Optional[str]:
    """:func:`split_problem` on the device's budget, memoised: a compiled
    forward checks its plan at every launch."""
    from repro_torch.core.roofline import device_profile
    return split_problem(split, dtype, K,
                         device_profile(device).smem_per_block)


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


def _zero_bias(x, w, b, int8: bool):
    """``b``, or the reference's default where it is None: zeros in fp32
    for the int8 mode and in x's dtype otherwise, on x's device."""
    if b is not None:
        return b
    return torch.zeros(w.shape[1], device=x.device,
                       dtype=torch.float32 if int8 else x.dtype)


def matmul_pipe_plain(x, w, b=None, *, relu=False, scale=None,
                      out_scale=None):
    """The plain version of each mode: the exact fp32 oracle, which in bf16
    sums in fp32 and rounds once to bf16, as the kernel does; or with
    ``scale`` the exact-int oracle of the int8 mode. ``b=None`` is zeros."""
    b = _zero_bias(x, w, b, scale is not None)
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


def matmul_pipe(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, relu: bool = False,
                scale: Optional[torch.Tensor] = None,
                out_scale: Optional[float] = None, split=None) -> torch.Tensor:
    """y = relu(x @ w + b). x (M, K); w (K, N); b (N,), None for zeros
    (fp32 in the int8 mode, else x's dtype), as in the JAX kernel.

    x, w and b all fp32 or all bf16 (y in their dtype); or the int8 mode:
    ``scale`` ((N,) fp32, s_x * s_w[n]) given, x and w int8;
    ``out_scale`` (a float) selects int8 output quantized by that step,
    None fp32 output. ``split`` = (tnf, ranks) pins the launch's split (a
    compiled plan); None takes :func:`fc_split`'s. A split the kernel
    cannot launch (:func:`split_problem`) raises on every device. A CPU
    tensor runs :func:`matmul_pipe_plain` (a split changes no result
    beyond fp32 rounding); a CUDA tensor launches the kernel (counted in
    ``matmul_pipe.launches``, fp32, ``matmul_pipe.launches_bf16`` or
    ``matmul_pipe.launches_s8``, int8) or raises."""
    b = _zero_bias(x, w, b, scale is not None)
    if split is not None:
        try:
            split = tuple(split)
        except TypeError:
            raise ValueError(f"matmul_pipe: split {split!r} is not (tnf, "
                             f"ranks)") from None
        why = _split_error(split, w.dtype, x.shape[-1], x.device)
        if why is not None:
            raise ValueError(f"matmul_pipe: {why}")
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
    split = tuple(int(v) for v in split) if split is not None else \
        fc_split(w.dtype, M, K, N, sm_count(x.device))
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
