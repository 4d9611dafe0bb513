"""The port's kernel modules against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. On a CPU
tensor each port wrapper runs its kernel's plain version. The Pallas
``conv_pipe`` cannot run under this jax (no ``pl.Unblocked``), so the
conv is held against ``repro.kernels.ops.fused_conv(use_pallas=False)``,
i.e. ``conv_pipe_ref``; ``matmul_pipe`` and ``lrn_pwl`` are held against
the Pallas kernels in interpret mode.
"""
import inspect
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lrn_pwl import build_pwl_lut as jax_build_pwl_lut
from repro.kernels.lrn_pwl import lrn_pwl as jax_lrn_pwl
from repro.kernels.matmul_pipe import matmul_pipe as jax_matmul_pipe
from repro_torch.kernels import ref
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import DECODE_TILE, decode_split
from repro_torch.kernels.conv_pipe import (FP32_BLOCK_COST, INT8_FILL,
                                           POSITIONS, conv_pipe,
                                           conv_tile, pool_tile)
from repro_torch.kernels.lrn_pwl import build_pwl_lut, lrn_pwl
from repro_torch.kernels.matmul_pipe import (FC_FEATURES, fc_chunk,
                                             fc_split, matmul_pipe)

FP32 = dict(rtol=1e-4, atol=1e-4)        # tests/test_kernels.py fp32 tolerance


def _both(a):
    a = np.ascontiguousarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize(
    "B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups",
    [
        (1, 8, 3, 3, 8, 1, 1, None, 2, 2, 1),
        (2, 16, 4, 3, 16, 1, 0, "max", 2, 2, 1),
        (1, 23, 3, 5, 8, 2, 2, "avg", 3, 2, 1),
        (1, 27, 3, 11, 16, 4, 0, "max", 3, 2, 1),   # AlexNet conv1 geometry
        (2, 14, 8, 1, 8, 1, 0, None, 2, 2, 1),       # 1x1 conv
        (1, 12, 6, 3, 12, 3, 1, None, 2, 2, 1),      # stride 3
        (2, 13, 16, 3, 24, 1, 1, None, 2, 2, 2),     # grouped (conv4)
        (2, 13, 8, 5, 16, 1, 2, None, 2, 2, 2),      # grouped 5x5 (conv2)
        (2, 13, 16, 3, 16, 1, 1, "max", 3, 2, 2),    # grouped + 3/2 pool (conv5)
    ])
def test_conv_matches_jax(B, H, C, K, M, stride, pad, pool, pool_k, pool_s,
                          groups):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.standard_normal((B, H, H, C)))
    wj, wt = _both(rng.standard_normal((K, K, C // groups, M)) * 0.2)
    bj, bt = _both(rng.standard_normal(M))
    kw = dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups)
    want = jops.fused_conv(xj, wj, bj, use_pallas=False, **kw)
    n0 = conv_pipe.launches
    got = conv_pipe(xt, wt, bt, **kw)
    assert conv_pipe.launches == n0          # a CPU tensor launches nothing
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **FP32)
    np.testing.assert_allclose(
        _np(ref.conv_pipe_ref(xt, wt, bt, **kw)), _np(want), **FP32)


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (64, 128, 32, 32, 16, 64),
    (100, 300, 70, 32, 32, 64),       # non-divisible => padded
    (1, 256, 1000, 8, 128, 128),      # single-row FC
    (64, 9216, 128, 64, 64, 256),     # AlexNet fc6-like K
])
def test_matmul_matches_jax_kernel(M, K, N, bm, bn, bk):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((M, K)) * 0.3)
    wj, wt = _both(rng.standard_normal((K, N)) * 0.05)
    bj, bt = _both(rng.standard_normal(N))
    want = jax_matmul_pipe(xj, wj, bj, relu=True, bm=bm, bn=bn, bk=bk,
                           interpret=True)
    got = matmul_pipe(xt, wt, bt, relu=True)
    np.testing.assert_allclose(_np(got), _np(want), **FP32)
    np.testing.assert_allclose(
        _np(ref.matmul_pipe_ref(xt, wt, bt, relu=False)),
        _np(jref.matmul_pipe_ref(xj, wj, bj, relu=False)), **FP32)


@pytest.mark.parametrize("n_sub_bits", [0, 1, 2, 3])
def test_pwl_lut_bit_equal_to_jax(n_sub_bits):
    s, i, shift, base = build_pwl_lut(n_sub_bits=n_sub_bits)
    js, ji, jshift, jbase = jax_build_pwl_lut(n_sub_bits=n_sub_bits)
    assert s.dtype == js.dtype == np.float32
    assert s.tobytes() == js.tobytes() and i.tobytes() == ji.tobytes()
    assert (shift, base) == (jshift, jbase)


@pytest.mark.parametrize("C", [8, 32, 96])
def test_lrn_pwl_matches_jax_kernel(C):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.standard_normal((2, 6, 6, C)) * 4)
    n0 = lrn_pwl.launches
    got = lrn_pwl(xt)
    assert lrn_pwl.launches == n0
    np.testing.assert_allclose(_np(got), _np(jax_lrn_pwl(xj, interpret=True)),
                               rtol=1e-5, atol=1e-6)
    exact = _np(ref.lrn_ref(xt))
    rel = np.max(np.abs(_np(got) - exact) / (np.abs(exact) + 1e-9))
    assert rel < 0.005, f"PWL error {rel:.4%} exceeds the paper's 0.5%"


@pytest.mark.parametrize("C", [3, 8, 96])
def test_lrn_ref_matches_jax(C):
    rng = np.random.default_rng(3)
    xj, xt = _both(rng.standard_normal((2, 5, 5, C)) * 4)
    np.testing.assert_allclose(_np(ref.lrn_ref(xt)), _np(jref.lrn_ref(xj)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("pool,k,s", [("max", 2, 2), ("max", 3, 2),
                                      ("avg", 2, 2), ("avg", 3, 2)])
def test_pool_ref_matches_jax(pool, k, s):
    rng = np.random.default_rng(4)
    xj, xt = _both(rng.standard_normal((2, 13, 11, 5)))
    np.testing.assert_allclose(_np(ref.pool_ref(xt, pool, k, s)),
                               _np(jref.pool_ref(xj, pool, k, s)),
                               rtol=1e-6, atol=1e-6)


def test_pool_ref_max_on_int8_codes_matches_jax():
    codes = np.random.default_rng(5).integers(-127, 128, (1, 7, 7, 3),
                                              dtype=np.int8)
    got = ref.pool_ref(torch.from_numpy(codes), "max", 3, 2)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.pool_ref(jnp.asarray(codes), "max", 3, 2)))


# every conv kernel's tile rows
TILE_ROWS = sorted(set(POSITIONS))
ANY_CG = 16             # a group's input channels: read by the int8 rule only


@pytest.mark.parametrize("positions", TILE_ROWS)
@pytest.mark.parametrize("ph,pw,k,s", [(6, 6, 3, 2), (13, 13, 3, 2),
                                       (112, 112, 2, 2), (1, 1, 8, 1)])
def test_pool_tile_fits_and_is_minimal(ph, pw, k, s, positions):
    tph, tpw = pool_tile(ph, pw, k, s, positions)
    area = ((tph - 1) * s + k) * ((tpw - 1) * s + k)
    assert 1 <= tph <= ph and 1 <= tpw <= pw and area <= positions
    blocks = -(-ph // tph) * -(-pw // tpw)
    assert all(-(-ph // a) * -(-pw // b) >= blocks
               for a in range(1, ph + 1) for b in range(1, pw + 1)
               if ((a - 1) * s + k) * ((b - 1) * s + k) <= positions)


@pytest.mark.parametrize("positions", TILE_ROWS)
def test_pool_tile_refuses_a_window_larger_than_the_tile(positions):
    k = math.isqrt(positions) + 1               # k*k > positions
    with pytest.raises(ValueError):
        pool_tile(2, 2, k, 1, positions)


# (B, OH, Mg, groups, pool, pool_k, pool_s) of each conv of AlexNet and
# VGG-16 at batch 8, and the bf16 tile a 132-SM H100 gets: the largest
# tile that still gives every SM a block, tn 64 where Mg <= 64
BF16_LAYER_TILES = [
    ((8, 55, 96, 1, None, 2, 2), (128, 128, 1, 1)),      # AlexNet conv1
    ((8, 27, 128, 2, None, 2, 2), (64, 128, 1, 1)),      # conv2
    ((8, 13, 384, 1, None, 2, 2), (64, 64, 1, 1)),       # conv3
    ((8, 13, 192, 2, None, 2, 2), (64, 64, 1, 1)),       # conv4
    ((8, 13, 128, 2, "max", 3, 2), (64, 64, 3, 3)),      # conv5 + pool
    ((8, 224, 64, 1, None, 2, 2), (128, 64, 1, 1)),      # VGG-16 conv1_1
    ((8, 224, 64, 1, "max", 2, 2), (128, 64, 2, 16)),    # conv1_2 + pool
    ((8, 112, 128, 1, "max", 2, 2), (128, 128, 4, 8)),   # conv2_2 + pool
    ((8, 56, 256, 1, None, 2, 2), (128, 128, 1, 1)),     # conv3_x
    ((8, 28, 512, 1, "max", 2, 2), (128, 128, 2, 14)),   # conv4_3 + pool
    ((8, 14, 512, 1, None, 2, 2), (64, 64, 1, 1)),       # conv5_x
    ((8, 14, 512, 1, "max", 2, 2), (64, 64, 2, 7)),      # conv5_3 + pool
]


def _patch_fits(layer, tile):
    """The pooled patch of ``tile`` = (tp, tn, tph, tpw) is pool_tile's
    for tp rows; returns the tile's block count."""
    B, OH, mg, groups, pool, k, s = layer
    tp, tn, tph, tpw = tile
    ph = OH if pool is None else (OH - k) // s + 1
    if pool is not None:
        assert (tph, tpw) == pool_tile(ph, ph, k, s, tp)
    tiles = -(-B * OH * OH // tp) if pool is None else \
        B * -(-ph // tph) * -(-ph // tpw)
    return tiles * groups * -(-mg // tn)


@pytest.mark.parametrize("layer,want", BF16_LAYER_TILES)
def test_bf16_tile_fills_the_card_with_the_largest_tile(layer, want):
    got = conv_tile(torch.bfloat16, layer[0], layer[1], layer[1], *layer[2:],
                    132, ANY_CG)
    assert got == want
    assert _patch_fits(layer, got) >= 128           # about a block an SM


# the fp32 tile of the same layers (and conv3_3 + pool, conv4_1/4_2): the
# fewest rounds of blocks an SM times FP32_BLOCK_COST, ties to tn 128
FP32_LAYER_TILES = [
    ((8, 55, 96, 1, None, 2, 2), (64, 128, 1, 1)),       # AlexNet conv1
    ((8, 27, 128, 2, None, 2, 2), (128, 128, 1, 1)),     # conv2
    ((8, 13, 384, 1, None, 2, 2), (64, 64, 1, 1)),       # conv3
    ((8, 13, 192, 2, None, 2, 2), (64, 64, 1, 1)),       # conv4
    ((8, 13, 128, 2, "max", 3, 2), (64, 64, 3, 3)),      # conv5 + pool
    ((8, 224, 64, 1, None, 2, 2), (128, 64, 1, 1)),      # VGG-16 conv1_1
    ((8, 224, 64, 1, "max", 2, 2), (128, 64, 2, 16)),    # conv1_2 + pool
    ((8, 112, 128, 1, "max", 2, 2), (128, 128, 4, 8)),   # conv2_2 + pool
    ((8, 56, 256, 1, None, 2, 2), (128, 128, 1, 1)),     # conv3_1/3_2
    ((8, 56, 256, 1, "max", 2, 2), (64, 128, 4, 4)),     # conv3_3 + pool
    ((8, 28, 512, 1, None, 2, 2), (64, 128, 1, 1)),      # conv4_1/4_2
    ((8, 28, 512, 1, "max", 2, 2), (128, 128, 2, 14)),   # conv4_3 + pool
    ((8, 14, 512, 1, None, 2, 2), (64, 128, 1, 1)),      # conv5_x
    ((8, 14, 512, 1, "max", 2, 2), (64, 128, 2, 7)),     # conv5_3 + pool
]


@pytest.mark.parametrize("layer,want", FP32_LAYER_TILES)
def test_fp32_conv_tile_takes_the_cheapest_rounds_of_blocks(layer, want):
    """The fp32 tile: no other tile that fits gives a smaller ceil(blocks
    / 132) x FP32_BLOCK_COST; the half tiles run where the 128x128 grid
    leaves SMs a round short (28x28, 14x14)."""
    got = conv_tile(torch.float32, layer[0], layer[1], layer[1], *layer[2:],
                    132, ANY_CG)
    assert got == want

    def cost(tile):
        return -(-_patch_fits(layer, tile) // 132) * FP32_BLOCK_COST[tile[:2]]
    B, OH, mg, groups, pool, k, s = layer
    ph = OH if pool is None else (OH - k) // s + 1
    for tp, tn in FP32_BLOCK_COST:
        if pool is None or k * k <= tp:
            t = (1, 1) if pool is None else pool_tile(ph, ph, k, s, tp)
            assert cost((tp, tn, *t)) >= cost(got)


# the int8 tile of the same layers (with each group's input channels, cg),
# the fastest of the four at every layer but conv2_1 in tile_sweep.py's
# times on an H100: tn 128 only where more than 64 channels share a dear
# gather (a pool's patch, or the element gather at cg 3), the 128-position
# tile unless it gives fewer than 3/4 of the SMs a block
INT8_LAYER_TILES = [
    ((8, 55, 96, 1, None, 2, 2), 3, (128, 128, 1, 1)),       # AlexNet conv1
    ((8, 27, 128, 2, None, 2, 2), 48, (128, 64, 1, 1)),      # conv2
    ((8, 13, 384, 1, None, 2, 2), 256, (64, 64, 1, 1)),      # conv3
    ((8, 13, 192, 2, None, 2, 2), 192, (64, 64, 1, 1)),      # conv4
    ((8, 13, 128, 2, "max", 3, 2), 192, (64, 64, 3, 3)),     # conv5 + pool
    ((8, 224, 64, 1, None, 2, 2), 3, (128, 64, 1, 1)),       # VGG-16 conv1_1
    ((8, 224, 64, 1, "max", 2, 2), 64, (128, 64, 2, 16)),    # conv1_2 + pool
    ((8, 112, 128, 1, None, 2, 2), 64, (128, 64, 1, 1)),     # conv2_1
    ((8, 112, 128, 1, "max", 2, 2), 128, (128, 128, 4, 8)),  # conv2_2 + pool
    ((8, 56, 256, 1, None, 2, 2), 128, (128, 64, 1, 1)),     # conv3_1/3_2
    ((8, 56, 256, 1, "max", 2, 2), 256, (128, 128, 1, 28)),  # conv3_3 + pool
    ((8, 28, 512, 1, None, 2, 2), 256, (128, 64, 1, 1)),     # conv4_1/4_2
    ((8, 28, 512, 1, "max", 2, 2), 512, (128, 128, 2, 14)),  # conv4_3 + pool
    ((8, 14, 512, 1, None, 2, 2), 512, (128, 64, 1, 1)),     # conv5_1/5_2
    ((8, 14, 512, 1, "max", 2, 2), 512, (128, 64, 4, 7)),    # conv5_3 + pool
]


@pytest.mark.parametrize("layer,cg,want", INT8_LAYER_TILES)
def test_int8_conv_tile_takes_the_measured_rule(layer, cg, want):
    """The pick, and that it is the rule's: its pool patch is pool_tile's,
    it gives at least INT8_FILL of the SMs a block unless no tile does,
    and tn is 128 only where more than 64 channels share a dear gather."""
    got = conv_tile(torch.int8, layer[0], layer[1], layer[1], *layer[2:],
                    132, cg)
    assert got == want
    blocks = _patch_fits(layer, got)
    assert blocks >= INT8_FILL * 132 or got[:2] == (64, 64)
    B, OH, mg, groups, pool, k, s = layer
    if got[1] == 128:
        assert mg > 64 and (pool is not None or cg % 16 > 0)


def test_bf16_tile_refuses_a_window_larger_than_either_tile():
    with pytest.raises(ValueError):
        conv_tile(torch.bfloat16, 1, 20, 20, 8, 1, "max", 12, 1, 132, ANY_CG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_conv_tile_refuses_a_window_larger_than_every_tile(dtype):
    k = math.isqrt(max(TILE_ROWS)) + 1          # k*k > every tile's rows
    with pytest.raises(ValueError):
        conv_tile(dtype, 1, 20, 20, 8, 1, "max", k, 1, 132, ANY_CG)


# (M, K, N) of AlexNet's and VGG-16's FC layers at batch 8, and the bf16
# split a 132-SM H100 gets: 64 features a cluster of 5 blocks (320 blocks)
# at fc6 and fc7; fc8's 1000 features in 32-feature tiles of 8 blocks
FC_LAYER_SPLITS = [
    ((8, 9216, 4096), (64, 5)),          # AlexNet fc6
    ((8, 25088, 4096), (64, 5)),         # VGG-16 fc6
    ((8, 4096, 4096), (64, 5)),          # fc7, both
    ((8, 4096, 1000), (32, 8)),          # fc8, both
]


@pytest.mark.parametrize("shape,want", FC_LAYER_SPLITS)
def test_fc_split_fills_the_card(shape, want):
    M, K, N = shape
    tnf, ranks = got = fc_split(torch.bfloat16, M, K, N, 132)
    assert got == want
    blocks = -(-N // tnf) * ranks * -(-M // 8)
    assert blocks >= (2 * 132 if N >= 4096 else 132)


# the fp32 split of the same layers on a 132-SM H100: one block an SM is
# enough for the FFMA stream (64 features x 3 ranks, 192 blocks, was the
# fastest of 24 splits at both fc6 and fc7 in tile_sweep.py's times; fc8's
# 32 x 5 was 13 % off its fastest, 32 x 7)
FP32_FC_LAYER_SPLITS = [
    ((8, 9216, 4096), (64, 3)),          # AlexNet fc6
    ((8, 25088, 4096), (64, 3)),         # VGG-16 fc6
    ((8, 4096, 4096), (64, 3)),          # fc7, both
    ((8, 4096, 1000), (32, 5)),          # fc8, both
]


@pytest.mark.parametrize("shape,want", FP32_FC_LAYER_SPLITS)
def test_fp32_fc_split_fills_the_card(shape, want):
    M, K, N = shape
    tnf, ranks = got = fc_split(torch.float32, M, K, N, 132)
    assert got == want
    assert tnf in FC_FEATURES[torch.float32]
    assert -(-N // tnf) * ranks * -(-M // 8) >= 132


# the int8 split of the same layers on a 132-SM H100: about 1.4 blocks an
# SM (128 features x 6 ranks, 192 blocks, was the fastest of 16 splits at
# VGG-16 fc6 in tile_sweep.py's times; fc8's 32 x 6 within 2 % of its
# fastest, 32 x 7)
INT8_FC_LAYER_SPLITS = [
    ((8, 9216, 4096), (128, 6)),         # AlexNet fc6
    ((8, 25088, 4096), (128, 6)),        # VGG-16 fc6
    ((8, 4096, 4096), (128, 6)),         # fc7, both
    ((8, 4096, 1000), (32, 6)),          # fc8, both
]


@pytest.mark.parametrize("shape,want", INT8_FC_LAYER_SPLITS)
def test_int8_fc_split_fills_the_card(shape, want):
    M, K, N = shape
    tnf, ranks = got = fc_split(torch.int8, M, K, N, 132)
    assert got == want
    assert tnf in FC_FEATURES[torch.int8]
    assert -(-N // tnf) * ranks * -(-M // 8) >= 132


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int8],
                         ids=["bf16", "fp32", "int8"])
@pytest.mark.parametrize("M,K,N", [(1, 16, 8), (8, 100, 1001), (64, 128, 32),
                                   (100, 300, 70), (8, 25088, 4096),
                                   (200, 4096, 4096)])
def test_fc_split_stays_within_the_kernel(dtype, M, K, N):
    """A feature tile the mode's kernel has, 1 to 8 ranks, never more than
    K has chunks: 64 k in bf16, 8 KB of w in fp32 (2048 / tnf k) and int8
    (8192 / tnf k). Ragged M (past 8), K (under one chunk) and N (not a
    multiple of 4 or 16)."""
    tnf, ranks = fc_split(dtype, M, K, N, 132)
    assert tnf in FC_FEATURES[dtype]
    chunk = fc_chunk(dtype, tnf)
    assert chunk == 64 if dtype == torch.bfloat16 \
        else chunk * tnf * dtype.itemsize == 8192
    assert 1 <= ranks <= min(8, -(-K // chunk))


# (B, HKV, S, G, D) of decode steps, and whether the shape is Qwen3-8B's
# (8 KV heads, G 4, d_head 128), whose splits must fill a 132-SM H100
DECODE_SHAPES = [
    ((1, 8, 4096, 4, 128), True),        # phase 6: B 1, 4096 slots
    ((8, 8, 32768, 4, 128), True),       # phase 5: decode_32k cut to B 8
    ((1, 8, 40, 4, 128), False),         # S below one 64-slot tile
    ((2, 2, 300, 1, 16), False),         # G 1, D 16, ragged S
    ((2, 2, 300, 8, 128), False),        # G 8, D 128, ragged S
    ((1, 4, 1000, 8, 16), False),        # G 8, D 16
    ((3, 1, 200, 1, 128), False),        # G 1, D 128
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,qwen", DECODE_SHAPES)
def test_decode_split_stays_within_the_cache_and_fills_the_card(dtype, shape,
                                                                qwen):
    """1 <= P <= the cache's 64-slot tiles; Qwen3-8B's
    shapes give at least one full wave of blocks on 132 SMs. The rule
    reads host values only: its arguments are the mode, B, HKV, S and the
    SM count (never pos, G or D), and plain ints give a plain int."""
    B, HKV, S, G, D = shape
    assert list(inspect.signature(decode_split).parameters) == [
        "dtype", "B", "HKV", "S", "sms"]
    P = decode_split(dtype, B, HKV, S, 132)
    assert type(P) is int
    assert 1 <= P <= -(-S // DECODE_TILE)
    if qwen:
        assert B * HKV * P >= 132


def test_library_path_hashes_the_headers_a_source_includes(tmp_path):
    """Editing csrc/hopper.cuh in a copy of csrc/ moves the library of
    every source that includes it, and of no other."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    # every kernel source includes the header; a source that does not
    (csrc / "standalone.cu").write_text('extern "C" int f() { return 0; }\n')
    names = ("conv_pipe", "matmul_pipe", "lrn_pwl")
    before = {n: build.library_path(n, csrc) for n in names + ("standalone",)}
    assert {n: before[n] for n in names} == {
        n: build.library_path(n) for n in names}
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build.library_path(n, csrc) for n in names + ("standalone",)}
    assert after["conv_pipe"] != before["conv_pipe"]
    assert after["matmul_pipe"] != before["matmul_pipe"]
    assert after["lrn_pwl"] != before["lrn_pwl"]
    assert after["standalone"] == before["standalone"]


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.zeros((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError):
        conv_pipe(x, torch.zeros((1, 1, 8, 8), device="meta"),
                  torch.zeros(8, device="meta"))
    with pytest.raises(ValueError):
        lrn_pwl(x)
    with pytest.raises(ValueError):
        matmul_pipe(x.reshape(8, 16), torch.zeros((16, 4), device="meta"),
                    torch.zeros(4, device="meta"))
