"""conv_pipe — the PipeCNN pipeline as one fused CUDA kernel.

conv + bias + ReLU (+ max/avg pool), grouped, in one launch per fusion
group, in fp32, in bf16 (bf16 x, w and b, an fp32 accumulator and
epilogue, bf16 out), or in int8 (``scale=`` given: int8 x and w, an int32
accumulator, and the requantize -> bias -> ReLU -> pool -> round
epilogue). Kernel: ``csrc/conv_pipe.cu``, which replaces the TPU kernel
``src/repro/kernels/conv_pipe.py:conv_pipe`` (line 198; all three modes).
Every mode is bound by operations. fp32 (FFMA, register-blocked, its
weights fed by a 3-stage ``cp.async`` ring) runs on the CUDA cores; bf16
(``mma.sync`` m16n8k16, bf16 products summed in fp32, as the TPU's MXU
computes the mode) and int8 (``mma.sync`` m16n8k32, int8 products summed
exactly in int32, the weights transposed to k-contiguous rows as they are
staged) run on the tensor cores, bound at their dense rates, with their
gathers fed by a 4-stage ``cp.async`` ring. Each computes an implicit GEMM
with the epilogue on a tile staged in shared memory, so the unpooled
activation never reaches device memory; :func:`conv_tile` picks each
layer's tile. See the source for the design. The plain version, :func:`conv_pipe_plain`, computes each
mode as the kernel rounds it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.ref import conv_pipe_ref, float_dtypes
from repro_torch.quant.ref import conv_int8_ref

from repro_torch.kernels.build import sm_count

__all__ = ["conv_pipe", "conv_pipe_plain", "conv_smem", "conv_tile",
           "pool_tile", "tile_problem"]

POSITIONS = (128, 64)        # every mode's tile rows (csrc TPB) and
CHANNELS = (128, 64)         # columns (csrc TN)
# The fp32 kernel's time for one block of each tile, relative to a
# 128x128 block, with two blocks an SM: the median over AlexNet's and
# VGG-16's batch-8 layers measured by tile_sweep.py on an H100 (PERF.md
# section 6). Half tiles cost 0.55-0.61, the quarter tile 0.33-0.40: a
# 4x4 micro-tile does 8 FFMA a shared load against the 8x8's 16.
FP32_BLOCK_COST = {(128, 128): 1.0, (128, 64): 0.56, (64, 128): 0.56,
                   (64, 64): 0.35}
# The int8 kernel's tile must give at least this share of the SMs a block
# before conv_tile falls back to a smaller one: at VGG-16's 14x14 layers
# 104 blocks of 128x64 beat 200 of 64x64 (tile_sweep.py, PERF.md section 6)
INT8_FILL = 0.75
_POOL_CODES = {None: 0, "max": 1, "avg": 2}
# The dynamic shared memory one launch requests, bytes: each instantiation's
# SMEM constexpr in csrc/conv_pipe.cu (F32Tile, BfTile, S8Tile), by mode and
# (tp, tn), the int8 tiles also by their reduction chunk (128 k where the
# gather takes 16-byte vectors, C/G % 16 == 0, else 64). chip_smoke.py and
# tests/test_torch_cuda.py hold it equal to the kernels' own
# (conv_pipe_smem in the library).
CONV_SMEM = {
    torch.float32: {(128, 128): 67584, (128, 64): 34816, (64, 128): 34048,
                    (64, 64): 21760},
    torch.bfloat16: {(128, 128): 75776, (128, 64): 59392, (64, 128): 55296,
                     (64, 64): 38912},
    (torch.int8, 128): {(128, 128): 110592, (128, 64): 92160,
                        (64, 128): 73728, (64, 64): 55296},
    (torch.int8, 64): {(128, 128): 69632, (128, 64): 51200,
                       (64, 128): 40960, (64, 64): 30720}}


def conv_smem(dtype: torch.dtype, tp: int, tn: int, cg: int) -> int:
    """The shared memory (bytes) a block of tile ``tp`` x ``tn`` requests in
    mode ``dtype``, for a layer with ``cg`` input channels a group; 0 where
    no kernel is instantiated at that tile."""
    key = (dtype, 128 if cg % 16 == 0 else 64) if dtype == torch.int8 \
        else dtype
    return CONV_SMEM.get(key, {}).get((tp, tn), 0)


def library_smem(dtype: torch.dtype, tp: int, tn: int, cg: int) -> int:
    """The shared memory the built kernel itself requests at this tile
    (``conv_pipe_smem`` in the library; -1 where none is instantiated):
    what :data:`CONV_SMEM` is held against. Builds the library."""
    from repro_torch.kernels import build
    fn = build.load("conv_pipe").conv_pipe_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    mode = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[dtype]
    return fn(mode, tp, tn, 128 if cg % 16 == 0 else 64)


def tile_problem(tile, dtype: torch.dtype, cg: int, ph: int, pw: int,
                 pool: Optional[str], pool_k: int, pool_s: int,
                 smem_budget: int) -> Optional[str]:
    """Why the kernel cannot launch ``tile`` = (tp, tn, tph, tpw), or None
    where it can: an instantiated (tp, tn) whose shared memory fits
    ``smem_budget``; with a pool, at least one pooled output a block each
    way and a conv patch ``((tph-1)*s+k) x ((tpw-1)*s+k)`` within the tp
    rows; without one, (tph, tpw) = (1, 1)."""
    try:
        tp, tn, tph, tpw = (int(v) for v in tile)
    except (TypeError, ValueError):
        return f"tile {tile!r} is not (tp, tn, tph, tpw)"
    smem = conv_smem(dtype, tp, tn, cg)
    if not smem:
        return (f"no {dtype} kernel is instantiated at {tp}x{tn}: tp in "
                f"{POSITIONS}, tn in {CHANNELS}")
    if smem > smem_budget:
        return (f"tile {tp}x{tn} needs {smem} B of shared memory, over the "
                f"budget of {smem_budget} B")
    if pool is None:
        if (tph, tpw) != (1, 1):
            return f"(tph, tpw) = ({tph}, {tpw}) without a pool: (1, 1)"
        return None
    if not (1 <= tph <= ph and 1 <= tpw <= pw):
        return (f"(tph, tpw) = ({tph}, {tpw}) outside the {ph}x{pw} pooled "
                f"map")
    patch = ((tph - 1) * pool_s + pool_k) * ((tpw - 1) * pool_s + pool_k)
    if patch > tp:
        return (f"the conv patch of ({tph}, {tpw}) pooled outputs "
                f"({pool_k}x{pool_k} pool, stride {pool_s}) is {patch} "
                f"positions, over the tile's {tp} rows")
    return None


@functools.lru_cache(maxsize=None)
def pool_tile(ph: int, pw: int, pool_k: int, pool_s: int,
              positions: int) -> Tuple[int, int]:
    """Pooled outputs per block, ``(tph, tpw)``, for a ``ph`` x ``pw``
    pooled map: the conv patch ``((tph-1)*s+k) x ((tpw-1)*s+k)`` must fit
    the kernel's ``positions`` tile rows, and every block costs the same,
    so take the fewest blocks (then the smallest patch). Memoised: the
    search is ph x pw steps of Python (12544 at VGG-16's conv1_2), longer
    than the kernel it sizes."""
    best = None
    for tph in range(1, ph + 1):
        for tpw in range(1, pw + 1):
            area = ((tph - 1) * pool_s + pool_k) * ((tpw - 1) * pool_s + pool_k)
            if area > positions:
                continue
            key = (-(-ph // tph) * -(-pw // tpw), area, tph, tpw)
            best = key if best is None or key < best else best
    if best is None:
        raise ValueError(f"conv_pipe: a {pool_k}x{pool_k} pool window does "
                         f"not fit the {positions}-position conv tile")
    return best[2], best[3]


def _position_tiles(B: int, OH: int, OW: int, pool: Optional[str],
                    pool_k: int, pool_s: int, tp: int):
    """``((tph, tpw), blocks along positions)`` of a tp-row tile, or None
    where a pool window does not fit tp rows."""
    if pool is None:
        return (1, 1), -(-B * OH * OW // tp)
    if pool_k * pool_k > tp:
        return None
    ph, pw = (OH - pool_k) // pool_s + 1, (OW - pool_k) // pool_s + 1
    t = pool_tile(ph, pw, pool_k, pool_s, tp)
    return t, B * -(-ph // t[0]) * -(-pw // t[1])


@functools.lru_cache(maxsize=None)
def conv_tile(dtype: torch.dtype, B: int, OH: int, OW: int, mg: int,
              groups: int, pool: Optional[str], pool_k: int, pool_s: int,
              sms: int, cg: int) -> Tuple[int, int, int, int]:
    """The tile of one layer's launch in mode ``dtype`` (x's dtype),
    ``(tp, tn, tph, tpw)``, from the card's ``sms``; ``cg`` is a group's
    input channels, ``mg`` its output channels.

    fp32: the tile whose blocks finish first: the fewest rounds of blocks
    an SM (``ceil(blocks / sms)``) times :data:`FP32_BLOCK_COST`, ties to
    the larger tn (fewer channel tiles re-gather the im2col rows less).
    bf16: tn 64 where a group has at most 64 output channels (VGG-16's
    conv1_x), else 128; the 128-position tile unless its grid gives fewer
    blocks than ``sms``, then the 64-position one, then tn 64 (the 13x13
    and 14x14 layers). int8 (measured by ``tile_sweep.py``): tn 128 only
    where the gather is dear and more than 64 channels share it (a pool's
    overlapping patch, or ``cg`` not a multiple of 16: the element
    gather), else 64; then 128 positions before 64, falling back only
    below :data:`INT8_FILL` of ``sms`` in blocks. With a pool,
    :func:`pool_tile` sizes the patch; a window that fits no tile raises.
    Memoised."""
    if dtype == torch.float32:
        tiles = sorted(FP32_BLOCK_COST, key=lambda t: (-t[1], -t[0]))
    elif dtype == torch.int8:
        tn = CHANNELS[0] if mg > CHANNELS[1] and (
            pool is not None or cg % 16) else CHANNELS[1]
        tiles = ((POSITIONS[0], tn), (POSITIONS[0], CHANNELS[1]),
                 (POSITIONS[1], CHANNELS[1]))
    else:
        tn = CHANNELS[1] if mg <= CHANNELS[1] else CHANNELS[0]
        tiles = ((POSITIONS[0], tn), (POSITIONS[1], tn),
                 (POSITIONS[1], CHANNELS[1]))
    fits = []                   # ((tp, tn, tph, tpw), blocks)
    for tp, tn in tiles:
        fit = _position_tiles(B, OH, OW, pool, pool_k, pool_s, tp)
        if fit is not None:
            fits.append(((tp, tn, *fit[0]), fit[1] * groups * -(-mg // tn)))
    if not fits:
        raise ValueError(f"conv_pipe: a {pool_k}x{pool_k} pool window fits "
                         f"no {dtype} conv tile")
    if dtype == torch.float32:
        return min(fits, key=lambda f: -(-f[1] // sms)
                   * FP32_BLOCK_COST[f[0][:2]])[0]
    need = INT8_FILL * sms if dtype == torch.int8 else sms
    return next((t for t, blocks in fits if blocks >= need), fits[-1][0])


def conv_pipe_plain(x, w, b, *, scale=None, out_scale=None, **kw):
    """The plain version of each mode: the exact fp32 oracle; in bf16 the
    fp32 oracle on the widened operands, rounded once to bf16 (the
    kernel's rounding; :func:`~repro_torch.kernels.ref.conv_pipe_ref` on
    bf16 rounds twice, as the JAX oracle does); or with ``scale`` the
    exact-int oracle of the int8 mode."""
    if scale is not None:
        return conv_int8_ref(x, w, b, scale, out_scale=out_scale, **kw)
    float_dtypes("conv_pipe", x, w, b)
    if x.dtype == torch.bfloat16:
        return conv_pipe_ref(x.float(), w.float(), b.float(),
                             **kw).to(torch.bfloat16)
    return conv_pipe_ref(x, w, b, **kw)


_FLOAT_ENTRY = {torch.float32: "conv_pipe_f32",
                torch.bfloat16: "conv_pipe_bf16"}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    from repro_torch.kernels import build
    fn = getattr(build.load("conv_pipe"), name)
    # the pointers (int8: then out_s8, out_scale), the geometry and the
    # tile (tp, tn), the stream
    if name == "conv_pipe_s8":
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_float] \
            + [ctypes.c_int] * 18 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + [
            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv_pipe(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
              scale: Optional[torch.Tensor] = None,
              out_scale: Optional[float] = None,
              stride: int = 1, pad: int = 0, relu: bool = True,
              pool: Optional[str] = None, pool_k: int = 2, pool_s: int = 2,
              groups: int = 1, tile=None) -> torch.Tensor:
    """Fused conv(+bias)(+ReLU)(+pool). x (B,H,W,C); w (KH,KW,C/G,M); b (M,).

    x, w and b all fp32 or all bf16 (the output in their dtype); or the
    int8 mode: ``scale`` ((M,) fp32, s_x * s_w[m]) given, x and w int8;
    ``out_scale`` (a float) selects int8 output quantized by that step,
    None fp32 output. ``tile`` = (tp, tn, tph, tpw) pins the launch's tile
    (a compiled plan); None takes :func:`conv_tile`'s. A tile the kernel
    cannot launch (:func:`tile_problem`) raises on every device. A CPU
    tensor runs :func:`conv_pipe_plain` (a tile changes no result); a CUDA
    tensor launches the kernel (counted in ``conv_pipe.launches``, fp32,
    ``conv_pipe.launches_bf16`` or ``conv_pipe.launches_s8``, int8) or
    raises."""
    if x.device.type == "cpu":
        if tile is not None:
            _check_tile(tile, x, w, stride, pad, pool, pool_k, pool_s,
                        scale is not None)
        return conv_pipe_plain(x, w, b, scale=scale, out_scale=out_scale,
                               stride=stride, pad=pad, relu=relu, pool=pool,
                               pool_k=pool_k, pool_s=pool_s, groups=groups)
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
    int8 = scale is not None
    if not int8:
        float_dtypes("conv_pipe", x, w, b)
    want = (("x", x, torch.int8), ("w", w, torch.int8), ("b", b, torch.float32),
            ("scale", scale, torch.float32)) if int8 else (
        ("x", x, x.dtype), ("w", w, x.dtype), ("b", b, x.dtype))
    for name, t, dtype in want:
        if (t.device != x.device or t.dtype != dtype or not t.is_contiguous()
                or t.data_ptr() % 4):
            raise ValueError(
                f"conv_pipe: {name} must be a contiguous, 4-byte aligned "
                f"{dtype} tensor on {x.device}, got {t.dtype} on {t.device}")
    if int8 and scale.shape != (M,):
        raise ValueError(f"conv_pipe: scale {tuple(scale.shape)} for "
                         f"{M} output channels")
    OH = (H + 2 * pad - KH) // stride + 1
    OW = (W + 2 * pad - KW) // stride + 1
    ph, pw = (OH, OW) if pool is None else (
        (OH - pool_k) // pool_s + 1, (OW - pool_k) // pool_s + 1)
    if min(OH, OW, ph, pw) <= 0:
        raise ValueError(f"conv_pipe: empty output for x {tuple(x.shape)}, "
                         f"kernel {KH}x{KW}, stride {stride}, pad {pad}, "
                         f"pool {pool}")
    bf16 = x.dtype == torch.bfloat16
    if tile is None:
        tile = conv_tile(x.dtype, B, OH, OW, M // groups, groups, pool,
                         pool_k, pool_s, sm_count(x.device), cg)
    else:
        _check_tile(tile, x, w, stride, pad, pool, pool_k, pool_s, int8)
    *tile, tph, tpw = (int(v) for v in tile)
    pk, ps = (1, 1) if pool is None else (pool_k, pool_s)
    out_s8 = int8 and out_scale is not None
    out = torch.empty((B, ph, pw, M), device=x.device,
                      dtype=torch.int8 if out_s8 else
                      torch.float32 if int8 else x.dtype)
    if out.numel() == 0:
        return out
    geo = (B, H, W, C, KH, KW, M, groups, stride, pad, int(relu),
           _POOL_CODES[pool], pk, ps, tph, tpw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if int8:
        err = _entry("conv_pipe_s8")(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), scale.data_ptr(),
            out.data_ptr(), int(out_s8), float(out_scale) if out_s8 else 1.0,
            *geo, *tile, stream)
    else:
        err = _entry(_FLOAT_ENTRY[x.dtype])(x.data_ptr(), w.data_ptr(),
                                            b.data_ptr(), out.data_ptr(),
                                            *geo, *tile, stream)
    if err:
        raise RuntimeError(f"conv_pipe kernel launch failed: CUDA error {err}")
    if int8:
        conv_pipe.launches_s8 += 1
    elif bf16:
        conv_pipe.launches_bf16 += 1
    else:
        conv_pipe.launches += 1
    return out


def _check_tile(tile, x, w, stride, pad, pool, pool_k, pool_s,
                int8: bool) -> None:
    """Raise where the kernel cannot launch ``tile`` on this layer (the
    device's shared memory a block is the budget)."""
    try:
        tile = tuple(tile)
    except TypeError:
        raise ValueError(f"conv_pipe: tile {tile!r} is not (tp, tn, tph, "
                         f"tpw)") from None
    why = _tile_error(tile, torch.int8 if int8 else x.dtype, x.shape[1],
                      x.shape[2], *w.shape[:3], stride, pad, pool, pool_k,
                      pool_s, x.device)
    if why is not None:
        raise ValueError(f"conv_pipe: {why}")


@functools.lru_cache(maxsize=None)
def _tile_error(tile, dtype, H, W, KH, KW, cg, stride, pad, pool, pool_k,
                pool_s, device) -> Optional[str]:
    """:func:`tile_problem` on one layer's geometry, memoised: a compiled
    forward checks its plan at every launch."""
    from repro_torch.core.roofline import device_profile
    OH = (H + 2 * pad - KH) // stride + 1
    OW = (W + 2 * pad - KW) // stride + 1
    ph, pw = (OH, OW) if pool is None else (
        (OH - pool_k) // pool_s + 1, (OW - pool_k) // pool_s + 1)
    return tile_problem(tile, dtype, cg, ph, pw, pool, pool_k, pool_s,
                        device_profile(device).smem_per_block)


conv_pipe.launches = 0           # fp32 launches
conv_pipe.launches_bf16 = 0      # bf16 launches
conv_pipe.launches_s8 = 0        # int8 launches
