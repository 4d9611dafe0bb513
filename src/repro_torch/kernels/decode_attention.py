"""decode_attention — one-token GQA attention over a KV cache, fused with
the cache write.

One call writes the new token's K and V into slot ``pos`` of the caches
in place (the TPU kernel aliases its cache inputs to its outputs for the
same end: one slot written, no copy of the cache) and attends over slots
``0..pos`` with an online softmax whose scores never leave the chip.
Kernels: ``csrc/decode_attention.cu``, which replaces the TPU kernel
``src/repro/kernels/decode_attention.py:decode_attention``. It is bound by
device-memory bytes (each cache slot up to ``pos`` read once), so the
slots of each (batch, KV head) are split over ``P`` blocks
(:func:`decode_split`, from host values only) whose fp32 partials a second
kernel merges in a fixed order; see the source for the design.
:func:`decode_attention` launches both on a CUDA tensor and runs
:func:`decode_attention_plain` on a CPU tensor.

Layout, as in the JAX package: q (B, HKV, G, D); caches (B, S, HKV, D);
new_k/new_v (B, HKV, D); one ``pos`` for the whole batch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple, Union

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import sm_count

__all__ = ["decode_attention", "decode_attention_plain", "decode_split"]

HEAD_DIMS = (16, 32, 64, 128)          # the head widths the kernel is built for
MAX_GROUP = 8                          # query heads per KV head, at most
DECODE_TILE = 64                       # slots a tile: a split's unit (csrc TS)
# decode_split's rule: the split blocks it wants on each SM, by mode: one
# wave of the blocks an SM holds (csrc RESIDENT: 3, the cp.async rings'
# 64 KB of shared memory a block at G <= 4). In tile_sweep.py's times on an
# H100 a partial second wave was the slowest split at B 8 (P 7 and 8, 448
# and 512 blocks, against P 6's 384), in both modes
DECODE_PER_SM = {torch.float32: 3, torch.bfloat16: 3}
_ENTRY = {torch.float32: "decode_attention_f32",
          torch.bfloat16: "decode_attention_bf16"}

Pos = Union[int, torch.Tensor]


def _write_slot(cache: torch.Tensor, new: torch.Tensor, pos: Pos) -> None:
    """cache[:, pos] = new, in place, without reading pos on the host."""
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).to(device=cache.device, dtype=torch.long)
        cache.index_copy_(1, idx, new[:, None])
    else:
        cache[:, pos] = new


@functools.lru_cache(maxsize=None)
def decode_split(dtype: torch.dtype, B: int, HKV: int, S: int,
                 sms: int) -> int:
    """P, the blocks that split the slots of each (batch, KV head): as
    many as one wave of :data:`DECODE_PER_SM` blocks an SM holds over the
    ``B * HKV`` heads, at most one a 64-slot tile of the cache; then the
    fewest that keep the longest share (in tiles) as short (B 1, S 4096:
    49 -> 32 splits of 2 tiles). It reads host values only, never
    ``pos``: each block works out its share of ``0..pos`` on the device,
    so a position that lives on the card and a CUDA-graph replay keep
    working. Memoised."""
    tiles = -(-S // DECODE_TILE)
    wave = max(1, DECODE_PER_SM[dtype] * sms // (B * HKV))
    share = -(-tiles // min(tiles, wave))
    return -(-tiles // share)


def decode_attention_plain(q, k_cache, v_cache, new_k, new_v, pos: Pos
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The kernel's function in plain PyTorch, with the same in-place cache
    write: slot ``pos`` of ``k_cache``/``v_cache`` becomes ``new_k``/
    ``new_v``, then the oracle
    :func:`repro_torch.kernels.ref.decode_attention_ref` attends over slots
    ``0..pos`` in fp32. Returns ``(o, k_cache, v_cache)``, the caches
    being the tensors given."""
    _write_slot(k_cache, new_k, pos)
    _write_slot(v_cache, new_v, pos)
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(()).to(q.device)
    o, _, _ = ref.decode_attention_ref(q, k_cache, v_cache, new_k, new_v, pos)
    return o, k_cache, v_cache


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    from repro_torch.kernels import build
    fn = getattr(build.load("decode_attention"), _ENTRY[dtype])
    # q, caches, new k/v, pos_dev; pos_host; o, ws; B, S, HKV, G, D, P
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, pos: Pos
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused decode attention with the in-place cache write.

    q (B, HKV, G, D); k_cache, v_cache (B, S, HKV, D); new_k, new_v
    (B, HKV, D); ``pos`` an int in [0, S) or an int32 tensor of one element
    on the caches' device, read there (never copied to the host). Returns
    ``(o (B, HKV, G, D), k_cache, v_cache)``, the caches being the tensors
    given, written at slot ``pos``.

    A CPU tensor runs :func:`decode_attention_plain`; a CUDA tensor
    launches the split kernel and its merge (one call, counted once in
    ``decode_attention.launches``, fp32, or
    ``decode_attention.launches_bf16``) or raises."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, new_k, new_v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}: expected (B, HKV, G, D) "
                         f"and (B, S, HKV, D)")
    B, HKV, G, D = q.shape
    S = k_cache.shape[1]
    if (k_cache.shape != (B, S, HKV, D) or v_cache.shape != k_cache.shape
            or new_k.shape != (B, HKV, D) or new_v.shape != new_k.shape):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, new "
            f"{tuple(new_k.shape)}/{tuple(new_v.shape)} disagree")
    if D not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention: head width {D} (kernel: "
                         f"{HEAD_DIMS}) or group {G} (kernel: 1..{MAX_GROUP})"
                         f" not supported")
    if q.dtype not in _ENTRY:
        raise ValueError(f"decode_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")
    dev, dtype = q.device, q.dtype
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("new_k", new_k), ("new_v", new_v)):
        if (t.device != dev or t.dtype != dtype
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(
                f"decode_attention: {name} must be a contiguous, 16-byte "
                f"aligned {q.dtype} tensor on {q.device}, got {t.dtype} on "
                f"{t.device}")
    if isinstance(pos, torch.Tensor):
        if (pos.device != dev or pos.dtype != torch.int32
                or pos.numel() != 1):
            raise ValueError(f"decode_attention: pos must be one int32 on "
                             f"{q.device}, got {pos.dtype} {tuple(pos.shape)}"
                             f" on {pos.device}")
        pos_dev, pos_host = pos.data_ptr(), 0
    else:
        if not 0 <= pos < S:
            raise ValueError(f"decode_attention: pos {pos} outside [0, {S})")
        pos_dev, pos_host = None, int(pos)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o, k_cache, v_cache
    P = decode_split(dtype, B, HKV, S, sm_count(dev))
    ws = torch.empty(B * HKV * P * G * (D + 2), dtype=torch.float32,
                     device=dev)          # the splits' partials
    err = _entry(dtype)(q.data_ptr(), k_cache.data_ptr(),
                          v_cache.data_ptr(), new_k.data_ptr(),
                          new_v.data_ptr(), pos_dev, pos_host, o.data_ptr(),
                          ws.data_ptr(), B, S, HKV, G, D, P,
                          1.0 / math.sqrt(D),
                          # the current stream's handle, without building a
                          # Stream object (5 us of host time a call)
                          torch._C._cuda_getCurrentRawStream(dev.index))
    if err:
        raise RuntimeError(
            f"decode_attention kernel launch failed: CUDA error {err}")
    if q.dtype == torch.bfloat16:
        decode_attention.launches_bf16 += 1
    else:
        decode_attention.launches += 1
    return o, k_cache, v_cache


decode_attention.launches = 0        # fp32 launches
decode_attention.launches_bf16 = 0   # bf16 launches
