"""codes — the int8 fold's passes over codes outside the fused kernels.

Kernels: ``csrc/codes.cu``. They replace no TPU kernel: the JAX package's
int8 fold leaves the network edge's quantize and a standalone max-pool on
codes to XLA, which fuses each into one pass; run eagerly they were five
launches and an unfold plus a strided reduce. Both kernels are bound by
device-memory bytes and make one pass: :func:`quantize_codes` (fp32 -> int8
codes at a per-tensor step, 16-byte loads) and :func:`max_pool_codes` (a
VALID k x k / s max-pool of NHWC codes, 16 channels a thread where C % 16
== 0). See the source for the design.

Each launches its kernel on a CUDA tensor (counted in its ``.launches``)
or raises, and runs its plain version on a CPU tensor:
:func:`quantize_codes_plain` is ``quant.core.quantize`` and
:func:`max_pool_codes_plain` is ``kernels.ref.pool_ref`` on the codes, bit
for bit what the kernels compute.
"""
from __future__ import annotations

import ctypes
import functools
import math
import numbers

import torch

from repro_torch.kernels.ref import pool_ref
from repro_torch.quant.core import quantize

__all__ = ["max_pool_codes", "max_pool_codes_plain", "quantize_codes",
           "quantize_codes_plain"]


def quantize_codes_plain(x: torch.Tensor, step: float) -> torch.Tensor:
    """x -> int8 codes clip(round(x / step), -127, 127), as
    ``quant.core.quantize``."""
    return quantize(x, step)


def max_pool_codes_plain(q: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """The VALID k x k / s max-pool of NHWC int8 codes, as ``pool_ref``."""
    return pool_ref(q, "max", k, s)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    from repro_torch.kernels import build
    fn = getattr(build.load("codes"), name)
    if name == "quantize_s8":            # x, y, total, step, stream
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                               ctypes.c_float, ctypes.c_void_p]
    else:                                # x, y, (B, H, W, C), k, s, stream
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _cuda(name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    """Refuse what the kernel does not take: another device, dtype, or a
    strided tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor, got "
                         f"{tuple(x.shape)} {x.dtype} "
                         f"contiguous={x.is_contiguous()}")


def _launched(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def quantize_codes(x: torch.Tensor, step: float) -> torch.Tensor:
    """x (fp32, any shape) -> int8 codes clip(round(x / step), -127, 127),
    rounding half to even; ``step`` a positive, finite Python number.

    A CPU tensor runs :func:`quantize_codes_plain`; a CUDA tensor launches
    the kernel (counted in ``quantize_codes.launches``) or raises."""
    if x.device.type == "cpu":
        return quantize_codes_plain(x, step)
    _cuda("quantize_codes", x, torch.float32)
    if not (isinstance(step, numbers.Real) and math.isfinite(step)
            and step > 0):
        raise ValueError(f"quantize_codes: step must be a positive, finite "
                         f"Python number, got {step!r}")
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if y.numel() == 0:
        return y
    _launched("quantize_codes", _entry("quantize_s8")(
        x.data_ptr(), y.data_ptr(), x.numel(), float(step),
        torch._C._cuda_getCurrentRawStream(x.device.index)))
    quantize_codes.launches += 1
    return y


def max_pool_codes(q: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """The VALID k x k / s max-pool of NHWC int8 codes ``q`` (B, H, W, C)
    -> (B, (H - k) // s + 1, (W - k) // s + 1, C) codes at q's step.

    A CPU tensor runs :func:`max_pool_codes_plain`; a CUDA tensor launches
    the kernel (counted in ``max_pool_codes.launches``) or raises."""
    if q.device.type == "cpu":
        return max_pool_codes_plain(q, k, s)
    _cuda("max_pool_codes", q, torch.int8)
    if q.dim() != 4 or k < 1 or s < 1 or min(q.shape[1:3]) < k:
        raise ValueError(f"max_pool_codes: needs NHWC codes of at least "
                         f"{k}x{k} pixels and k, s >= 1, got "
                         f"{tuple(q.shape)}, k={k}, s={s}")
    if q.numel() >= 2 ** 31:
        raise ValueError(f"max_pool_codes: {q.numel()} elements; the kernel "
                         f"takes fewer than 2^31")
    B, H, W, C = q.shape
    y = torch.empty((B, (H - k) // s + 1, (W - k) // s + 1, C),
                    dtype=torch.int8, device=q.device)
    if y.numel() == 0:
        return y
    _launched("max_pool_codes", _entry("max_pool_s8")(
        q.data_ptr(), y.data_ptr(), B, H, W, C, k, s,
        torch._C._cuda_getCurrentRawStream(q.device.index)))
    max_pool_codes.launches += 1
    return y


quantize_codes.launches = 0
max_pool_codes.launches = 0
