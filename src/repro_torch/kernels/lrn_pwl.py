"""lrn_pwl — LRN with PipeCNN's piecewise-linear exponent-segmented LUT.

The paper approximates z^(-beta) piecewise-linearly, with segment
boundaries at powers of 2^(-n): the segment index is read off the float's
exponent bits plus the top n mantissa bits,

    Addr = (bitcast(z) >> Shift_Bit) - base

Kernel: ``csrc/lrn_pwl.cu``, which replaces the TPU kernel
``src/repro/kernels/lrn_pwl.py:lrn_pwl`` in both of its element types
(fp32, and bf16 computed in fp32 and rounded once on output), and in an
int8 mode the int8 fold's dequantize -> LRN -> requantize, which XLA fused
around that kernel in the JAX package (codes in and out, bit for bit the
chain). The float modes are bound by device-memory bytes (one read and
one write of the activation), the int8 mode, at a byte a value, by its
instructions: a thread takes one 16-byte vector of one pixel's channels
and gets the window's halo from its neighbouring lanes by shuffles, one
pass with no loop; where C is no multiple of the vector a thread takes
one element. It launches as a programmatic dependent, which overlaps it
with an LRN before it but not with conv_pipe, its predecessor in the
forward. See the source for the design and its times. :func:`lrn_pwl`
launches it on a CUDA tensor and runs :func:`lrn_pwl_plain` (int8:
:func:`lrn_pwl_s8_plain`) on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools
import math
import numbers
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# AlexNet LRN constants
LRN_N = 5
LRN_K = 2.0
LRN_ALPHA = 1e-4
LRN_BETA = 0.75


@functools.lru_cache(maxsize=None)
def build_pwl_lut(beta: float = LRN_BETA, n_sub_bits: int = 2,
                  z_min_exp: int = 0, z_max_exp: int = 16
                  ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Slope/intercept LUT for f(z)=z^-beta over z in [2^min, 2^max).

    A copy of the JAX package's ``build_pwl_lut``: the exponent plus the
    top-n mantissa bits split each octave into 2^n linear segments, and
    each chord is shifted down by half its peak deviation (minimax), which
    is what lets n=2 meet the paper's 0.5 % bound. Cached: callers must not
    write to the returned arrays.
    """
    n_sub = 1 << n_sub_bits
    n_seg = (z_max_exp - z_min_exp) * n_sub
    edges = np.concatenate([
        2.0 ** e * (1.0 + np.arange(n_sub) / n_sub)
        for e in range(z_min_exp, z_max_exp)] + [[2.0 ** z_max_exp]])
    f = edges ** (-beta)
    slope = (f[1:] - f[:-1]) / (edges[1:] - edges[:-1])
    intercept = f[:-1] - slope * edges[:-1]
    for i in range(n_seg):
        zs = np.linspace(edges[i], edges[i + 1], 65)
        dev = (slope[i] * zs + intercept[i]) - zs ** (-beta)
        intercept[i] -= dev.max() / 2.0
    shift = 23 - n_sub_bits
    base = (127 + z_min_exp) << n_sub_bits
    slope, intercept = slope.astype(np.float32), intercept.astype(np.float32)
    slope.setflags(write=False)
    intercept.setflags(write=False)
    return slope, intercept, shift, base


def lrn_pwl_plain(x: torch.Tensor, *, n: int = LRN_N, k: float = LRN_K,
                  alpha: float = LRN_ALPHA, beta: float = LRN_BETA,
                  n_sub_bits: int = 2) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order of
    operations. x (B, H, W, C) fp32, or bf16: computed in fp32 on the
    widened values and rounded once to bf16, as the kernel does."""
    if x.dtype == torch.bfloat16:
        return lrn_pwl_plain(x.float(), n=n, k=k, alpha=alpha, beta=beta,
                             n_sub_bits=n_sub_bits).to(torch.bfloat16)
    slope, icpt, shift, base = build_pwl_lut(beta, n_sub_bits)
    slope = torch.from_numpy(slope.copy()).to(x.device)
    icpt = torch.from_numpy(icpt.copy()).to(x.device)
    sq = x * x
    acc = sq
    for d in range(1, n // 2 + 1):
        acc = acc + torch.nn.functional.pad(sq[..., d:], (0, d))
        acc = acc + torch.nn.functional.pad(sq[..., :-d], (d, 0))
    z = k + (alpha / n) * acc
    addr = ((z.view(torch.int32) >> shift) - base).clamp(0, len(slope) - 1)
    return x * (slope[addr] * z + icpt[addr])


def lrn_pwl_s8_plain(q: torch.Tensor, x_scale: float, y_scale: float, *,
                     n: int = LRN_N, k: float = LRN_K,
                     alpha: float = LRN_ALPHA, beta: float = LRN_BETA,
                     n_sub_bits: int = 2) -> torch.Tensor:
    """The int8 mode's plain version: int8 codes ``q`` at step ``x_scale``
    -> int8 codes at step ``y_scale``, by the chain the mode replaces,
    ``quantize(lrn_pwl_plain(dequantize(q, x_scale)), y_scale)``."""
    # imported here: repro_torch.quant imports kernels.ref, which imports
    # this module's constants
    from repro_torch.quant.core import dequantize, quantize
    y = lrn_pwl_plain(dequantize(q, x_scale), n=n, k=k, alpha=alpha,
                      beta=beta, n_sub_bits=n_sub_bits)
    return quantize(y, y_scale)


# (device index, beta, n_sub_bits) -> (slope, intercept, shift, base, n_seg)
_LUTS: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor, int, int, int]] = {}


def _device_lut(device: torch.device, beta: float, n_sub_bits: int):
    """The LUT on ``device`` with its addressing constants, built once a
    device index."""
    key = (device.index, beta, n_sub_bits)
    lut = _LUTS.get(key)
    if lut is None:
        slope, icpt, shift, base = build_pwl_lut(beta, n_sub_bits)
        lut = _LUTS[key] = (torch.from_numpy(slope.copy()).to(device),
                            torch.from_numpy(icpt.copy()).to(device),
                            shift, base, len(slope))
    return lut


_ENTRY = {torch.float32: "lrn_pwl_f32", torch.bfloat16: "lrn_pwl_bf16",
          torch.int8: "lrn_pwl_s8"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    from repro_torch.kernels import build
    fn = getattr(build.load("lrn_pwl"), _ENTRY[dtype])
    steps = [ctypes.c_float] * 2 if dtype == torch.int8 else []
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        *steps, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _steps(x: torch.Tensor, x_scale, y_scale) -> bool:
    """Whether ``x`` is int8 codes, whose mode takes both steps (Python
    numbers; ``y_scale`` positive and finite, as it divides); a float ``x``
    takes neither."""
    int8 = x.dtype == torch.int8
    given = (x_scale is not None, y_scale is not None)
    if given != (int8, int8):
        raise ValueError(f"lrn_pwl: x_scale and y_scale go with int8 codes "
                         f"and only with them; got {x.dtype} with "
                         f"x_scale={x_scale!r}, y_scale={y_scale!r}")
    if int8 and not (isinstance(x_scale, numbers.Real)
                     and isinstance(y_scale, numbers.Real)
                     and math.isfinite(y_scale) and y_scale > 0):
        raise ValueError(f"lrn_pwl: the steps must be Python numbers, "
                         f"y_scale positive and finite; got "
                         f"x_scale={x_scale!r}, y_scale={y_scale!r}")
    return int8


def lrn_pwl(x: torch.Tensor, *, x_scale: Optional[float] = None,
            y_scale: Optional[float] = None, n: int = LRN_N,
            k: float = LRN_K, alpha: float = LRN_ALPHA,
            beta: float = LRN_BETA, n_sub_bits: int = 2) -> torch.Tensor:
    """LRN with the PWL-exponent approximation. x (B, H, W, C) fp32 or
    bf16, y in x's dtype; or the int8 mode: x int8 codes at step
    ``x_scale``, y int8 codes at step ``y_scale``.

    A CPU tensor runs :func:`lrn_pwl_plain` (:func:`lrn_pwl_s8_plain`);
    a CUDA tensor launches the kernel (counted in ``lrn_pwl.launches``,
    fp32, ``lrn_pwl.launches_bf16`` or ``lrn_pwl.launches_s8``) or
    raises."""
    int8 = _steps(x, x_scale, y_scale)
    kw = dict(n=n, k=k, alpha=alpha, beta=beta, n_sub_bits=n_sub_bits)
    if x.device.type == "cpu":
        if int8:
            return lrn_pwl_s8_plain(x, x_scale, y_scale, **kw)
        return lrn_pwl_plain(x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"lrn_pwl: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in _ENTRY or not x.is_contiguous():
        raise ValueError(
            f"lrn_pwl: needs a contiguous 4-D float32, bfloat16 or int8 "
            f"NHWC tensor, got {tuple(x.shape)} {x.dtype} "
            f"contiguous={x.is_contiguous()}")
    total = x.numel()
    if total >= 2 ** 31:
        raise ValueError(f"lrn_pwl: {total} elements; the kernel takes "
                         f"fewer than 2^31")
    slope, icpt, shift, base, n_seg = _device_lut(x.device, beta, n_sub_bits)
    y = torch.empty_like(x)
    if total == 0:
        return y
    steps = (float(x_scale), float(y_scale)) if int8 else ()
    err = _entry(x.dtype)(x.data_ptr(), y.data_ptr(), slope.data_ptr(),
                          icpt.data_ptr(), n_seg, total, x.shape[3], n, k,
                          alpha / n, shift, base, *steps,
                          # the current stream's handle, without building a
                          # Stream object (5 us of host time a call)
                          torch._C._cuda_getCurrentRawStream(x.device.index))
    if err:
        raise RuntimeError(f"lrn_pwl kernel launch failed: CUDA error {err}")
    if int8:
        lrn_pwl.launches_s8 += 1
    elif x.dtype == torch.bfloat16:
        lrn_pwl.launches_bf16 += 1
    else:
        lrn_pwl.launches += 1
    return y


lrn_pwl.launches = 0             # fp32 launches
lrn_pwl.launches_bf16 = 0        # bf16 launches
lrn_pwl.launches_s8 = 0          # int8 launches
