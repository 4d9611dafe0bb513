"""flash_attention — causal attention with an online softmax, GQA-aware.

The LM-side instance of the PipeCNN dataflow: the (S x S) score matrix
exists only a tile at a time, in shared memory and registers, never in
device memory. Kernel: ``csrc/flash_attention.cu``, which replaces the TPU
kernel ``src/repro/kernels/flash_attention.py:flash_attention`` together
with the head repeat ``repro.kernels.ops.attention`` puts in front of it:
query head ``h`` reads KV head ``h // (Hq // Hkv)`` in place. It is bound by
operations. fp32 runs on FFMA on the CUDA cores, as the TPU kernel computes
in fp32, where every FFMA needs an issue slot: a block of 8 warps takes a
128-row query tile, each lane 8 rows x 4 keys of S and the same 8 rows of
O, so every 16-byte shared load feeds 16 or 32 FFMAs, and K and V stream
into separate two-stage ``cp.async`` rings a tile ahead (3.37 ms at
Qwen3-8B's 4096-token prefill, 61 % of the FFMA bound, against 4.29 ms for
64-row tiles fed through registers, on an NVIDIA H100 80GB HBM3 at 700 W).
bf16 runs on the tensor cores (``mma.sync``, fp32 sums, P rounded once to
bf16 for the second product). See the source for the design.
:func:`flash_attention` launches it on a CUDA tensor and runs
:func:`flash_attention_plain` on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import ref

__all__ = ["flash_attention", "flash_attention_plain"]

HEAD_DIMS = (16, 32, 64, 128)          # the head widths the kernel is built for
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the KV heads repeated
    (query head ``h`` reads KV head ``h // g``), then the oracle
    :func:`repro_torch.kernels.ref.flash_attention_ref` (fp32 softmax,
    cast to q's dtype). q (B, Hq, S, D); k, v (B, Hkv, S, D) with Hkv
    dividing Hq."""
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return ref.flash_attention_ref(q, k, v)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    from repro_torch.kernels import build
    fn = getattr(build.load("flash_attention"), _ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention. q (B, Hq, S, D); k, v (B, Hkv, S, D), Hkv
    dividing Hq; returns (B, Hq, S, D) in q's dtype (fp32 or bf16).

    A CPU tensor runs :func:`flash_attention_plain`; a CUDA tensor launches
    the kernel (counted in ``flash_attention.launches``, fp32, or
    ``flash_attention.launches_bf16``) or raises. Any S: the kernel masks
    the ragged tile. Queries and keys must be equally long: the kernel
    masks ``k_pos > q_pos``, as the TPU kernel does, and the oracle
    ``tril(k=Sk-Sq)``; the two agree only at Sq == Sk, the only case the
    JAX package runs."""
    if q.dim() == 4 and k.dim() == 4 and q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention: {q.shape[2]} queries and "
                         f"{k.shape[2]} keys: the kernel and its oracle "
                         f"agree only at equal lengths")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         f"(B, Hq, Sq, D) and two equal (B, Hkv, Sk, D)")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (Hq must be a multiple "
                         f"of Hkv)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {D} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention: {name} must be a contiguous, 16-byte "
                f"aligned {q.dtype} tensor on {q.device}, got {t.dtype} on "
                f"{t.device}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), B, Hq, Hkv, S, S, D,
                          1.0 / math.sqrt(D),
                          # the current stream's handle, without building a
                          # Stream object (5 us of host time a call)
                          torch._C._cuda_getCurrentRawStream(q.device.index))
    if err:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    if q.dtype == torch.bfloat16:
        flash_attention.launches_bf16 += 1
    else:
        flash_attention.launches += 1
    return o


flash_attention.launches = 0         # fp32 launches
flash_attention.launches_bf16 = 0    # bf16 launches
