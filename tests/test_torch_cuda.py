"""The port's CUDA kernels against their plain versions, on the card.

Every test takes the ``cuda`` fixture, which skips without a CUDA device.
This file imports no JAX, so it runs on the card without the repository's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: conv/matmul ``|kernel - plain| <= 1e-4 * max(1, max|plain|)``
(fp32 sums in another order, TF32 off on the plain side; the split-K FC
kernel also gives the same bits on two calls); LRN bit for bit in
fp32 (same operations, same order, each rounded explicitly) and within
one bf16 ulp in bf16. The int8 modes are held
bit for bit (``torch.equal``): the int32 accumulator is exact on both
sides (the conv's and the FC's on the int8 tensor cores, the FC's in any
split-K order) and the epilogue rounds the same steps. Attention (flash
and decode): ``1e-4 * max(1, max|plain|)`` in fp32 (online vs full
softmax, fp32 sums in another order) and ``2e-2`` in bf16 (the
reference's bf16 tolerance, ``tests/test_kernels.py:17-19``; flash's
bf16 kernel also rounds P to bf16 for its second tensor-core product);
the decode caches bit for bit (one slot copied, nothing computed). The
bf16 modes of conv_pipe, matmul_pipe and lrn_pwl: ``rtol = atol = 2e-2``
against plain versions that compute in fp32 and round once to bf16, as
the kernels do (conv_pipe's on the tensor cores: bf16 products, fp32
sums).
"""
import dataclasses
import importlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.codes import (max_pool_codes, max_pool_codes_plain,
                                       quantize_codes)
from repro_torch.kernels.conv_pipe import (CHANNELS, POSITIONS, conv_pipe,
                                           conv_pipe_plain, pool_tile)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (HEAD_DIMS, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.lrn_pwl import (lrn_pwl, lrn_pwl_plain,
                                          lrn_pwl_s8_plain)
from repro_torch.kernels.ref import pool_ref
from repro_torch.kernels.matmul_pipe import (FC_FEATURES, fc_chunk,
                                             matmul_pipe,
                                             matmul_pipe_plain)
from repro_torch.models.cnn import init_cnn_params
from repro_torch.pipeline import ExecutionSpec, Precision, compile_cnn
from repro_torch.quant import calibrate_cnn, dequantize, quantize


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run this file on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def _close(got, want):
    assert got.shape == want.shape
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert err <= tol, f"max abs err {err:.3e} > {tol:.1e}"


CONV_GEOMETRIES = [
        (1, 8, 3, 3, 8, 1, 1, None, 2, 2, 1),
        (2, 16, 4, 3, 16, 1, 0, "max", 2, 2, 1),
        (1, 23, 3, 5, 8, 2, 2, "avg", 3, 2, 1),
        (1, 27, 3, 11, 16, 4, 0, "max", 3, 2, 1),   # AlexNet conv1 geometry
        (2, 14, 8, 1, 8, 1, 0, None, 2, 2, 1),       # 1x1 conv
        (1, 12, 6, 3, 12, 3, 1, None, 2, 2, 1),      # stride 3
        (2, 13, 16, 3, 24, 1, 1, None, 2, 2, 2),     # grouped, AlexNet conv4
        (2, 13, 16, 3, 16, 1, 1, "max", 3, 2, 2),    # grouped + 3/2 pool (conv5)
        (3, 29, 6, 5, 160, 1, 2, "max", 3, 2, 2),    # several M and H tiles
        (1, 32, 5, 3, 70, 1, 1, "max", 2, 2, 1),     # VGG 2/2 pool, ragged M
]
MATMUL_SHAPES = [(64, 128, 32), (100, 300, 70), (1, 256, 1000),
                 (64, 9216, 128), (8, 9216, 4096), (8, 300, 1001)]
# bf16 geometries that reach the tensor-core kernel's 16-byte cp.async
# gather (C/G % 8 == 0) and its edges: K not a multiple of the 32-wide
# chunk, Mg not a multiple of the 64- or 128-channel tile, several row and
# channel tiles, the 4-stage ring wrapping many times, groups, pools over
# the larger tiles ragged at the pooled edge, batch 1 and 3; and the
# element-by-element gather of the first convs (C/G = 3).
BF16_CONV_GEOMETRIES = [
    (2, 27, 96, 5, 256, 1, 2, None, 2, 2, 2),   # AlexNet conv2: C/G 48, K 1200
    (1, 10, 8, 3, 16, 1, 1, None, 2, 2, 1),     # C/G 8, K 72: 2 chunks + tail
    (3, 20, 48, 3, 96, 1, 1, None, 2, 2, 1),    # K 432 (13.5 chunks), Mg 96
    (1, 30, 64, 3, 200, 1, 1, None, 2, 2, 1),   # K 576 (18 chunks), Mg 200
    (3, 56, 64, 3, 200, 1, 1, None, 2, 2, 1),   # 74 row tiles of 128, 2 col
    (1, 14, 512, 3, 512, 1, 1, None, 2, 2, 1),  # VGG-16 conv5: K 4608
    (1, 30, 64, 3, 96, 1, 1, "max", 2, 2, 1),   # 2x2/2 pool, PH 15: ragged
    (3, 27, 48, 3, 200, 1, 1, "max", 3, 2, 1),  # 3x3/2 pool, PH 13: ragged
    (3, 29, 16, 3, 64, 1, 0, "avg", 3, 2, 2),   # G 2, C/G 8, avg pool
    (2, 28, 64, 3, 64, 1, 1, "max", 2, 2, 1),   # VGG-16 conv1_2 + pool, cut
    (3, 16, 3, 3, 64, 1, 1, None, 2, 2, 1),     # C/G 3, K 27: element gather
    (1, 63, 3, 11, 96, 4, 0, None, 2, 2, 1),    # AlexNet conv1, cut: K 363
]
# int8 geometries that reach the tensor-core kernel's 16-byte gather (C/G
# % 16 == 0: 16, 32, 48, 64, 512) and ones that leave it (C/G 3, 8, 24),
# with K not a multiple of the 64-wide chunk, Mg ragged against the 64- and
# 128-channel tiles (and not a multiple of 16, 8 or 4: the element paths
# of the weight loads and the stores), several row and channel tiles, the
# ring wrapping many times (K 4608: 72 chunks), groups, and max and avg
# pools ragged at the pooled edge
INT8_CONV_GEOMETRIES = [
    (2, 27, 96, 5, 256, 1, 2, None, 2, 2, 2),   # AlexNet conv2: C/G 48, K 1200
    (1, 10, 16, 3, 16, 1, 1, None, 2, 2, 1),    # C/G 16, K 144: 2 chunks + tail
    (3, 20, 48, 3, 96, 1, 1, None, 2, 2, 1),    # K 432 (6.75 chunks), Mg 96
    (3, 56, 64, 3, 200, 1, 1, None, 2, 2, 1),   # 74 row tiles of 128, Mg 200
    (1, 14, 512, 3, 512, 1, 1, None, 2, 2, 1),  # VGG-16 conv5: K 4608
    (1, 30, 64, 3, 96, 1, 1, "max", 2, 2, 1),   # 2x2/2 pool, PH 15: ragged
    (3, 27, 48, 3, 200, 1, 1, "max", 3, 2, 1),  # 3x3/2 pool, PH 13: ragged
    (3, 29, 32, 3, 64, 1, 0, "avg", 3, 2, 2),   # G 2, C/G 16, avg pool
    (2, 28, 64, 3, 64, 1, 1, "max", 2, 2, 1),   # VGG-16 conv1_2 + pool, cut
    (3, 16, 3, 3, 64, 1, 1, None, 2, 2, 1),     # C/G 3, K 27: element gather
    (1, 63, 3, 11, 96, 4, 0, None, 2, 2, 1),    # AlexNet conv1, cut: K 363
    (2, 12, 8, 3, 40, 1, 1, None, 2, 2, 1),     # C/G 8: element gather, Mg 40
    (2, 13, 48, 3, 36, 1, 1, "max", 3, 2, 2),   # G 2: C/G 24, Mg 18
    (1, 9, 24, 1, 6, 1, 0, "avg", 2, 2, 1),     # C/G 24, 1x1, Mg 6
]
# every conv kernel's tiles (tp, tn)
TILES = [(tp, tn) for tp in POSITIONS for tn in CHANNELS]


@pytest.mark.parametrize(
    "B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups", CONV_GEOMETRIES)
def test_conv_pipe_kernel_matches_plain(cuda, B, H, C, K, M, stride, pad,
                                        pool, pool_k, pool_s, groups):
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((B, H, H, C)), cuda)
    w = _t(rng.standard_normal((K, K, C // groups, M)) * 0.2, cuda)
    b = _t(rng.standard_normal(M), cuda)
    kw = dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups)
    n0 = conv_pipe.launches
    _close(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))
    assert conv_pipe.launches == n0 + 1


def _force_tile(monkeypatch, tile):
    """Make the conv wrapper launch ``tile`` (tp, tn) on every layer,
    whichever tile :func:`conv_tile` would choose there."""
    def forced(dtype, B, OH, OW, mg, groups, pool, pool_k, pool_s, sms, cg):
        if pool is None:
            return (*tile, 1, 1)
        return (*tile, *pool_tile((OH - pool_k) // pool_s + 1,
                                  (OW - pool_k) // pool_s + 1, pool_k,
                                  pool_s, tile[0]))
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.conv_pipe"), "conv_tile", forced)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups",
                         CONV_GEOMETRIES + BF16_CONV_GEOMETRIES)
def test_conv_pipe_fp32_every_tile_matches_plain(cuda, monkeypatch, tile, B,
                                                 H, C, K, M, stride, pad,
                                                 pool, pool_k, pool_s,
                                                 groups):
    """Each of the fp32 kernel's four tiles on every geometry: the
    element gathers (C/G 3, 5, 6; Mg 70) and the 16-byte ones (C/G % 4 ==
    0) with K tails, ragged channel tiles, groups and pools."""
    _force_tile(monkeypatch, tile)
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((B, H, H, C)), cuda)
    w = _t(rng.standard_normal((K, K, C // groups, M)) * 0.2, cuda)
    b = _t(rng.standard_normal(M), cuda)
    kw = dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups)
    _close(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))


def test_conv_pipe_fp32_unaligned_operands(cuda):
    """x, w and out at 4-byte but not 16-byte aligned addresses take the
    element paths and give the same result."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((2, 20, 20, 64)), cuda)
    w = _t(rng.standard_normal((3, 3, 64, 96)) * 0.2, cuda)
    b = _t(rng.standard_normal(96), cuda)
    kw = dict(pad=1, pool="max")

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        u = buf[1:].view(t.shape)
        u.copy_(t)
        return u
    xu, wu = shifted(x), shifted(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    _close(conv_pipe(xu, wu, b, **kw), conv_pipe_plain(x, w, b, **kw))


@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_matmul_pipe_kernel_matches_plain(cuda, M, K, N, relu):
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((M, K)) * 0.3, cuda)
    w = _t(rng.standard_normal((K, N)) * 0.05, cuda)
    b = _t(rng.standard_normal(N), cuda)
    n0 = matmul_pipe.launches
    _close(matmul_pipe(x, w, b, relu=relu),
           matmul_pipe_plain(x, w, b, relu=relu))
    assert matmul_pipe.launches == n0 + 1


# NHWC shapes for lrn_pwl: C a multiple of both vectors (8, 32, 96, 256),
# of the fp32 vector only (4, 12, 100), of neither (3: the scalar path),
# pixels whose vectors straddle warps (96, 100), one pixel
LRN_SHAPES = [(2, 6, 6, 8), (2, 6, 6, 32), (2, 6, 6, 96), (1, 5, 7, 3),
              (8, 27, 27, 256), (2, 6, 6, 4), (2, 6, 6, 12), (2, 6, 6, 100),
              (1, 1, 1, 96)]


@pytest.mark.parametrize("shape", LRN_SHAPES)
def test_lrn_pwl_kernel_matches_plain(cuda, shape):
    """The same operations in the same order, explicitly rounded: the
    kernel equals its plain version bit for bit."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal(shape) * 4, cuda)
    n0 = lrn_pwl.launches
    got, want = lrn_pwl(x), lrn_pwl_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    assert lrn_pwl.launches == n0 + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 4), device=cuda)
    w = torch.zeros((3, 3, 4, 8), device=cuda)
    b = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError):
        conv_pipe(x.transpose(1, 2), w, b)            # not contiguous
    with pytest.raises(ValueError):
        conv_pipe(x.double(), w, b)                   # not fp32
    with pytest.raises(ValueError):
        conv_pipe(x, w, b, groups=3)                  # C % groups
    with pytest.raises(ValueError):
        matmul_pipe(x.reshape(16, 16), w.reshape(36, 8), b)   # K mismatch
    with pytest.raises(ValueError):
        lrn_pwl(x.reshape(4, 4, 16))                  # not 4-D


def _codes(rng, shape, lo=-127, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int8))


def _requant(rng, n, k, dev):
    """A per-channel multiplier that maps the int32 sums of k random
    int8 products to O(1), and a bias."""
    scale = (0.5 + rng.random(n)) / (127.0 ** 2 / 3 * np.sqrt(k))
    return _t(scale, dev), _t(rng.standard_normal(n) * 0.5, dev)


OUT_SCALE = 3.0 / 127          # int8 output step: |y| <= 3 keeps its code


def _equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, want), (
        f"{int((diff > 0).sum())} of {diff.numel()} differ, "
        f"max {diff.max().item()}")


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
@pytest.mark.parametrize(
    "B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups", CONV_GEOMETRIES)
def test_conv_pipe_int8_kernel_equals_plain(cuda, B, H, C, K, M, stride,
                                            pad, pool, pool_k, pool_s,
                                            groups, quant_out):
    rng = np.random.default_rng(10)
    x = _codes(rng, (B, H, H, C)).to(cuda)
    w = _codes(rng, (K, K, C // groups, M)).to(cuda)
    scale, b = _requant(rng, M, K * K * C // groups, cuda)
    kw = dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups, scale=scale,
              out_scale=OUT_SCALE if quant_out else None)
    n0, s0 = conv_pipe.launches, conv_pipe.launches_s8
    _equal(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))
    assert (conv_pipe.launches, conv_pipe.launches_s8) == (n0, s0 + 1)


def _int8_conv_case(seed, B, H, C, K, M, stride, pad, pool, pool_k, pool_s,
                    groups, quant_out, dev):
    rng = np.random.default_rng(seed)
    x = _codes(rng, (B, H, H, C)).to(dev)
    w = _codes(rng, (K, K, C // groups, M)).to(dev)
    scale, b = _requant(rng, M, K * K * C // groups, dev)
    return x, w, b, dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
                         pool_s=pool_s, groups=groups, scale=scale,
                         out_scale=OUT_SCALE if quant_out else None)


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups",
                         INT8_CONV_GEOMETRIES)
def test_conv_pipe_int8_every_tile_equals_plain(cuda, monkeypatch, tile, B,
                                                H, C, K, M, stride, pad,
                                                pool, pool_k, pool_s, groups,
                                                quant_out):
    """Each of the int8 tensor-core kernel's four tiles, with int8 and fp32
    output, on every geometry, whichever tile the wrapper would choose."""
    _force_tile(monkeypatch, tile)
    x, w, b, kw = _int8_conv_case(14, B, H, C, K, M, stride, pad, pool,
                                  pool_k, pool_s, groups, quant_out, cuda)
    _equal(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))


@pytest.mark.parametrize("out_scale", [2.0, 2.0 * (1 + 2 ** -23),
                                       2.0 * (1 - 2 ** -24), 0.5, 10 / 7,
                                       2.0 ** -20])
@pytest.mark.parametrize("C", [16, 8], ids=["vector", "element"])
def test_conv_pipe_int8_rounds_ties_as_the_plain_version(cuda, C, out_scale):
    """The requantize's ties and near-ties: a 1x1 conv that copies integer
    codes (scale 1, bias 0 or 0.25) and out_scale 2 (odd codes / 2 are
    exact halves, rounded to even), 2 (1 +- an ulp) (quotients an ulp off
    a half), 0.5, 10/7 and 2^-20 (most codes clip): the kernel's cheap
    product must give way to the division wherever the codes could
    differ."""
    rng = np.random.default_rng(16)
    M = 48
    x = _codes(rng, (2, 9, 9, C)).to(cuda)
    w = np.zeros((1, 1, C, M), np.int8)
    w[0, 0, np.arange(M) % C, np.arange(M)] = 1
    w = torch.from_numpy(w).to(cuda)
    for bias in (0.0, 0.25):
        b = torch.full((M,), bias, device=cuda)
        kw = dict(relu=False, scale=torch.ones(M, device=cuda),
                  out_scale=out_scale)
        _equal(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
def test_conv_pipe_int8_unaligned_operands(cuda, quant_out):
    """x and w at 4-byte but not 16- or 8-byte aligned addresses take the
    element gather and the element weight loads and give the same bits."""
    x, w, b, kw = _int8_conv_case(15, 2, 20, 64, 3, 128, 1, 1, "max", 2, 2,
                                  1, quant_out, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
        u = buf[4:].view(t.shape)
        u.copy_(t)
        return u
    xu, wu = shifted(x), shifted(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 8
    _equal(conv_pipe(xu, wu, b, **kw), conv_pipe_plain(x, w, b, **kw))


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_matmul_pipe_int8_kernel_equals_plain(cuda, M, K, N, relu,
                                              quant_out):
    rng = np.random.default_rng(11)
    x, w = _codes(rng, (M, K)).to(cuda), _codes(rng, (K, N)).to(cuda)
    scale, b = _requant(rng, N, K, cuda)
    kw = dict(relu=relu, scale=scale,
              out_scale=OUT_SCALE if quant_out else None)
    n0, s0 = matmul_pipe.launches, matmul_pipe.launches_s8
    _equal(matmul_pipe(x, w, b, **kw), matmul_pipe_plain(x, w, b, **kw))
    assert (matmul_pipe.launches, matmul_pipe.launches_s8) == (n0, s0 + 1)


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
def test_int8_sums_past_2_to_the_24_round_alike(cuda, quant_out):
    """fc6's K = 9216 with large positive codes: |acc| ~ 1e8 > 2^24, so
    the int32 -> fp32 conversion rounds; kernel and plain must agree."""
    rng = np.random.default_rng(12)
    x = _codes(rng, (8, 9216), 90, 128).to(cuda)
    w = _codes(rng, (9216, 256), 60, 128).to(cuda)
    acc = x.double() @ w.double()
    assert acc.abs().min().item() > 2 ** 24
    scale = torch.full((256,), 1.0 / acc.max().item(), device=cuda)
    b = torch.zeros(256, device=cuda)
    kw = dict(scale=scale, out_scale=1.0 / 127 if quant_out else None)
    _equal(matmul_pipe(x, w, b, **kw), matmul_pipe_plain(x, w, b, **kw))
    xc, wc = x.reshape(8, 1, 1, 9216), w.reshape(1, 1, 9216, 256)
    _equal(conv_pipe(xc, wc, b, **kw), conv_pipe_plain(xc, wc, b, **kw))


def _int8_fc_case(seed, M, K, N, quant_out, dev):
    rng = np.random.default_rng(seed)
    x, w = _codes(rng, (M, K)).to(dev), _codes(rng, (K, N)).to(dev)
    scale, b = _requant(rng, N, K, dev)
    return x, w, b, dict(scale=scale,
                         out_scale=OUT_SCALE if quant_out else None)


# int8 FC shapes for every split: M past 8 and ragged (several grid rows),
# K under a chunk or not a multiple of it nor of the ranks' share, and the
# cp.async vector of w's rows (N) and x's rows (K) at each width: 16, 8, 4
# bytes and byte by byte
SPLIT_SHAPES = [(8, 4096, 1000), (13, 1000, 200), (3, 200, 1001)]
INT8_SPLIT_SHAPES = SPLIT_SHAPES + [(5, 4098, 70), (9, 4100, 36),
                                    (20, 2048, 256)]


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("split", [(tnf, r)
                                   for tnf in FC_FEATURES[torch.int8]
                                   for r in (1, 2, 3, 5, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("M,K,N", INT8_SPLIT_SHAPES)
def test_matmul_pipe_int8_every_split_equals_plain(cuda, monkeypatch, split,
                                                   M, K, N, relu, quant_out):
    """Each int8 feature tile at 1 to 8 ranks a cluster (more ranks than K
    has chunks at K 200: some blocks sum nothing), whichever split fc_split
    would choose, bit for bit: integer sums are exact in any split."""
    _force_split(monkeypatch, split)
    x, w, b, kw = _int8_fc_case(29, M, K, N, quant_out, cuda)
    _equal(matmul_pipe(x, w, b, relu=relu, **kw),
           matmul_pipe_plain(x, w, b, relu=relu, **kw))


@pytest.mark.parametrize("quant_out", [True, False], ids=["s8out", "f32out"])
@pytest.mark.parametrize("K", [1024, 1000, 1004, 1001])
@pytest.mark.parametrize("N", [256, 200, 36, 37])
def test_matmul_pipe_int8_unaligned_rows_equal_plain(cuda, K, N, quant_out):
    """Rows of x (K) and w (N) that start 16-, 8-, 4- or 1-byte aligned
    take the cp.async vector of that width (bytes at 1) into the same
    shared layout, and give the same bits."""
    x, w, b, kw = _int8_fc_case(30, 8, K, N, quant_out, cuda)
    _equal(matmul_pipe(x, w, b, relu=True, **kw),
           matmul_pipe_plain(x, w, b, relu=True, **kw))


@pytest.mark.parametrize("M,K,N", [(8, 25088, 4096), (13, 1000, 200),
                                   (8, 4098, 1001)])
def test_matmul_pipe_int8_is_deterministic(cuda, M, K, N):
    """Two calls of the split-K int8 kernel give the same bits."""
    x, w, b, kw = _int8_fc_case(31, M, K, N, False, cuda)
    y1, y2 = matmul_pipe(x, w, b, **kw), matmul_pipe(x, w, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def test_quantize_on_the_card_equals_the_cpu(cuda):
    """1M values, a quarter of them exact ties (k + 0.5) * s: a division
    by the reciprocal would flip codes at the ties."""
    rng = np.random.default_rng(13)
    s = 0.0371
    ties = (rng.integers(-140, 140, 250_000) + 0.5) * np.float32(s)
    x = np.concatenate([ties, rng.standard_normal(750_000) * 3]).astype(
        np.float32)
    cpu = torch.from_numpy(x)
    for scale in (s, torch.full((1,), s)):
        want = quantize(cpu, scale)
        got = quantize(cpu.to(cuda), scale.to(cuda) if torch.is_tensor(scale)
                       else scale)
        assert torch.equal(got.cpu(), want)


def test_calibrate_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("alexnet").smoke()
    params = init_cnn_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    calib = np.random.default_rng(123).standard_normal(
        (4, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    want = calibrate_cnn(params, calib, cfg)
    got = calibrate_cnn([None if p is None else {k: v.to(cuda) for k, v in
                                                 p.items()} for p in params],
                        calib, cfg)
    assert got.in_scale == want.in_scale
    for g, w in zip(got.layers, want.layers, strict=True):
        assert (g is None) == (w is None)
        if w is None:
            continue
        for name in ("x_scale", "y_scale"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None)
            if b is not None:
                assert a == pytest.approx(b, rel=1e-5)
        if w.w_q is not None:
            assert torch.equal(g.w_q.cpu(), w.w_q)
            assert torch.equal(g.w_scale.cpu(), w.w_scale)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 8, 8, 4), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, 4, 8), dtype=torch.int8, device=cuda)
    b = torch.zeros(8, device=cuda)
    s = torch.ones(8, device=cuda)
    with pytest.raises(ValueError):
        conv_pipe(x.float(), w, b, scale=s)                 # fp32 x
    with pytest.raises(ValueError):
        conv_pipe(x, w, b.to(torch.int8), scale=s)          # int8 bias
    with pytest.raises(ValueError):
        conv_pipe(x.transpose(1, 2), w, b, scale=s)         # not contiguous
    with pytest.raises(ValueError):
        conv_pipe(x, w, b, scale=s[:4])                     # scale shape
    xf, wf = x.reshape(16, 16), torch.zeros((16, 8), dtype=torch.int8,
                                            device=cuda)
    with pytest.raises(ValueError):
        matmul_pipe(xf.float(), wf, b, scale=s)             # fp32 x
    with pytest.raises(ValueError):
        matmul_pipe(xf, wf, b.to(torch.int8), scale=s)      # int8 bias
    with pytest.raises(ValueError):
        matmul_pipe(xf, wf.t().contiguous().t(), b, scale=s)  # not contiguous


# -- the int8 glue: lrn_pwl's int8 mode, the edge quantize, the pool on codes

def _glue_counts():
    return (lrn_pwl.launches, lrn_pwl.launches_s8, quantize_codes.launches,
            max_pool_codes.launches)


def _codes_with_ends(rng, shape, dev):
    """Random int8 codes with +127 and -127 in every pixel."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    q[..., 0], q[..., -1] = 127, -127
    return torch.from_numpy(q).to(dev)


def _lrn_chain(q, xs, ys):
    """What the int8 fold ran before the mode: dequantize, the fp32 LRN
    kernel, quantize, each its own launches."""
    return quantize(lrn_pwl(dequantize(q, xs)), ys)


# AlexNet's two LRNs at batch 2 (16-byte vectors), a C that is no multiple
# of 16 and one under it (the scalar path), pixels straddling warps
LRN_S8_SHAPES = [(2, 55, 55, 96), (2, 27, 27, 256), (2, 6, 6, 24),
                 (1, 5, 7, 3), (2, 6, 6, 48)]
LRN_S8_STEPS = [(0.0371, 0.05), (1.0 / 127, 2.0 / 127), (0.5, 0.25)]


@pytest.mark.parametrize("steps", LRN_S8_STEPS, ids=str)
@pytest.mark.parametrize("shape", LRN_S8_SHAPES, ids=str)
def test_lrn_pwl_int8_kernel_equals_the_chain(cuda, shape, steps):
    """One launch of the int8 mode equals its plain version and the chain
    of launches it replaces, bit for bit."""
    xs, ys = steps
    q = _codes_with_ends(np.random.default_rng(40), shape, cuda)
    n0 = _glue_counts()
    got = lrn_pwl(q, x_scale=xs, y_scale=ys)
    assert _glue_counts() == (n0[0], n0[1] + 1, n0[2], n0[3])
    _equal(got, lrn_pwl_s8_plain(q, xs, ys))
    _equal(got, _lrn_chain(q, xs, ys))


@pytest.mark.parametrize("C", [96, 256, 24])
def test_lrn_pwl_int8_rounds_ties_as_the_chain(cuda, C):
    """Steps that put the dequantize's products on fp32 rounding ties (x
    step 1 + 2^-23 times a power of two: q * x_step needs 31 bits, and an
    odd q drops a half ulp) and the requantize's quotients within an ulp
    of a half-integer (y step = 2 y0 / (2j + 1) for values y0 the chain
    gives): quant_code's fallback to the division decides those."""
    xs = float(np.float32(1 + 2 ** -23) * np.float32(2 ** -5))
    rng = np.random.default_rng(41)
    # codes from -3 to 3 (odd ones tie), so that windows, and the values
    # the chain gives, repeat across the tensor
    q = torch.from_numpy(rng.integers(-3, 4, (2, 9, 9, C)).astype(
        np.int8)).to(cuda)
    y = lrn_pwl(dequantize(q, xs)).flatten()
    nonzero = y.nonzero().flatten().cpu().numpy()
    for j, i in enumerate(rng.choice(nonzero, 6)):
        ys = abs(float(y[i])) * 2 / (2 * j + 3)
        _equal(lrn_pwl(q, x_scale=xs, y_scale=ys), _lrn_chain(q, xs, ys))


def _quantize_values(rng, s, n=250_000):
    """Exact ties (k + 0.5) * s, values past +-127 steps, and noise."""
    ties = (rng.integers(-140, 140, n) + 0.5) * np.float32(s)
    far = rng.choice([-1.0, 1.0], n) * rng.uniform(127.5, 400, n) * s
    return np.concatenate([ties, far, rng.standard_normal(2 * n) * 3,
                           [np.inf, -np.inf]]).astype(np.float32)


@pytest.mark.parametrize("s", [0.0371, 1.0 / 127, 0.1, 2.5])
def test_quantize_codes_equals_quantize(cuda, s):
    rng = np.random.default_rng(42)
    x = torch.from_numpy(_quantize_values(rng, s)).to(cuda)
    n0 = _glue_counts()
    got = quantize_codes(x, s)
    assert _glue_counts() == (*n0[:2], n0[2] + 1, n0[3])
    _equal(got, quantize(x, s))
    _equal(got.cpu(), quantize(x.cpu(), s))


@pytest.mark.parametrize("n", [1, 3, 5, 17, 4099])
def test_quantize_codes_tails_and_unaligned(cuda, n):
    """A total that is no multiple of 4 (the last values one at a time),
    and x or y off the 16- and 4-byte alignment (all of them so)."""
    s = 0.0371
    x = torch.from_numpy(_quantize_values(np.random.default_rng(43), s,
                                          n)[:n]).to(cuda)
    _equal(quantize_codes(x, s), quantize(x, s))
    buf = torch.empty(n + 1, dtype=torch.float32, device=cuda)
    xu = buf[1:]
    xu.copy_(x)
    assert xu.data_ptr() % 16
    _equal(quantize_codes(xu, s), quantize(x, s))


POOL_S8_SHAPES = [(2, 55, 55, 96), (2, 27, 27, 256), (2, 13, 13, 16),
                  (1, 9, 11, 3), (2, 8, 8, 40)]


@pytest.mark.parametrize("k,s", [(3, 2), (2, 2)], ids=["3x3s2", "2x2s2"])
@pytest.mark.parametrize("shape", POOL_S8_SHAPES, ids=str)
def test_max_pool_codes_equals_pool_ref(cuda, shape, k, s):
    """Every int8 code, -128 too, through the vector (C % 16 == 0) and the
    scalar paths."""
    q = torch.from_numpy(np.random.default_rng(44).integers(
        -128, 128, shape).astype(np.int8)).to(cuda)
    n0 = _glue_counts()
    got = max_pool_codes(q, k, s)
    assert _glue_counts() == (*n0[:3], n0[3] + 1)
    _equal(got, pool_ref(q, "max", k, s))
    _equal(got, max_pool_codes_plain(q, k, s))


def test_max_pool_codes_unaligned(cuda):
    q = torch.from_numpy(np.random.default_rng(45).integers(
        -128, 128, (2, 13, 13, 32)).astype(np.int8)).to(cuda)
    buf = torch.empty(q.numel() + 1, dtype=torch.int8, device=cuda)
    qu = buf[1:].view(q.shape)
    qu.copy_(q)
    assert qu.data_ptr() % 16
    _equal(max_pool_codes(qu, 3, 2), pool_ref(q, "max", 3, 2))


def test_glue_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 8, 16), dtype=torch.int8, device=cuda)
    n0 = _glue_counts()
    with pytest.raises(ValueError):
        lrn_pwl(q)                                      # no steps
    with pytest.raises(ValueError):
        lrn_pwl(q, x_scale=0.1, y_scale=0.0)            # a zero step
    with pytest.raises(ValueError):
        quantize_codes(q.float(), torch.tensor(0.1))    # a tensor step
    with pytest.raises(ValueError):
        quantize_codes(q.double(), 0.1)                 # fp64
    with pytest.raises(ValueError):
        quantize_codes(q.float().transpose(1, 2), 0.1)  # not contiguous
    with pytest.raises(ValueError):
        max_pool_codes(q.float(), 2, 2)                 # not codes
    with pytest.raises(ValueError):
        max_pool_codes(q, 9, 2)                         # window past H
    assert _glue_counts() == n0


def _int8_alexnet(cuda, batch=2):
    cfg = get_config("alexnet")
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(quant="int8", calib=4)),
        generator=torch.Generator().manual_seed(46), device=cuda)
    x = torch.from_numpy(np.random.default_rng(47).standard_normal(
        (batch, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(
            np.float32)).to(cuda)
    return cfg, compiled, x


def test_int8_alexnet_forward_equals_the_chain(cuda):
    """Full-width AlexNet in int8: the forward, with its glue in the new
    kernels, gives the logits of the fold as it ran before (quantize,
    dequantize -> fp32 lrn_pwl -> quantize, pool_ref), bit for bit."""
    from repro_torch.models.cnn import run_group_quant
    cfg, compiled, x = _int8_alexnet(cuda)
    qp = compiled.params
    got = compiled.forward(x)
    with torch.inference_mode():
        q = quantize(x, qp.in_scale)
        for group in compiled.model.groups:
            l, ql = cfg.layers[group[0]], qp.layers[group[0]]
            if l.kind == "pool":
                q = pool_ref(q, l.pool, l.kernel, l.stride)
            elif l.kind == "lrn":
                q = _lrn_chain(q, ql.x_scale, ql.y_scale)
            else:
                q = run_group_quant(qp, q, cfg, group,
                                    plans=compiled.model.plans)
    _equal(got, q)


def test_int8_alexnet_forward_launches_the_glue_kernels(cuda):
    """One forward: 2 int8 LRNs, 1 edge quantize, 2 pools, no fp32 LRN,
    beside conv_pipe's 5 and matmul_pipe's 3 int8 launches."""
    _, compiled, x = _int8_alexnet(cuda)
    n0 = _glue_counts()
    c0, m0 = conv_pipe.launches_s8, matmul_pipe.launches_s8
    compiled.forward(x)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_glue_counts(), n0)) == (0, 2, 1, 2)
    assert (conv_pipe.launches_s8 - c0, matmul_pipe.launches_s8 - m0) == \
        (5, 3)


# ---------------------------------------------------------------------------
# the bf16 modes of the CNN kernels
# ---------------------------------------------------------------------------

BF16 = dict(rtol=2e-2, atol=2e-2)        # tests/test_kernels.py:17-19, bf16


def _bf(a, dev):
    return _t(a, dev).to(torch.bfloat16)


def _close_bf16(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **BF16)


def _counts(fn):
    return fn.launches, fn.launches_bf16, getattr(fn, "launches_s8", 0)




def _bf16_conv_case(seed, B, H, C, K, M, stride, pad, pool, pool_k, pool_s,
                    groups, dev):
    rng = np.random.default_rng(seed)
    x = _bf(rng.standard_normal((B, H, H, C)), dev)
    w = _bf(rng.standard_normal((K, K, C // groups, M)) * 0.2, dev)
    b = _bf(rng.standard_normal(M), dev)
    return x, w, b, dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
                         pool_s=pool_s, groups=groups)


@pytest.mark.parametrize("B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups",
                         CONV_GEOMETRIES + BF16_CONV_GEOMETRIES)
def test_conv_pipe_bf16_kernel_matches_plain(cuda, B, H, C, K, M, stride,
                                             pad, pool, pool_k, pool_s,
                                             groups):
    x, w, b, kw = _bf16_conv_case(20, B, H, C, K, M, stride, pad, pool,
                                  pool_k, pool_s, groups, cuda)
    n0, h0, s0 = _counts(conv_pipe)
    _close_bf16(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))
    assert _counts(conv_pipe) == (n0, h0 + 1, s0)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups",
                         BF16_CONV_GEOMETRIES)
def test_conv_pipe_bf16_every_tile_matches_plain(cuda, monkeypatch, tile, B,
                                                 H, C, K, M, stride, pad,
                                                 pool, pool_k, pool_s,
                                                 groups):
    """Each of the kernel's four tiles on every geometry, whichever tile
    the wrapper would choose there."""
    _force_tile(monkeypatch, tile)
    x, w, b, kw = _bf16_conv_case(23, B, H, C, K, M, stride, pad, pool,
                                  pool_k, pool_s, groups, cuda)
    _close_bf16(conv_pipe(x, w, b, **kw), conv_pipe_plain(x, w, b, **kw))


def test_conv_pipe_bf16_unaligned_operands(cuda):
    """x and w at 4-byte but not 16-byte aligned addresses take the
    element-by-element gathers and give the same result."""
    x, w, b, kw = _bf16_conv_case(24, 2, 20, 64, 3, 96, 1, 1, "max", 2, 2,
                                  1, cuda)

    def shifted(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
        u = buf[2:].view(t.shape)
        u.copy_(t)
        return u
    xu, wu = shifted(x), shifted(w)
    assert xu.data_ptr() % 16 and wu.data_ptr() % 16
    _close_bf16(conv_pipe(xu, wu, b, **kw), conv_pipe_plain(x, w, b, **kw))


def _sass(name):
    """{function: its SASS} of kernel library ``name``, by cuobjdump."""
    from repro_torch.kernels import build
    build.load(name)
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          check=True, capture_output=True, text=True).stdout
    funcs, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            funcs[fn] = ""
        elif fn is not None:
            funcs[fn] += line + "\n"
    return funcs


def test_bf16_conv_runs_on_the_tensor_cores(cuda):
    """cuobjdump's SASS of the built libraries: every bf16 conv, matmul
    and flash attention kernel (flash_bf16_mma_kernel<D>) holds
    HMMA (tensor-core) instructions, every int8 conv kernel
    (conv_s8_mma_kernel<TPB, TN, BK, TO>: each tile at chunks of 128 and
    64 k, int8 and fp32 out) and every int8 matmul kernel
    (matmul_s8_kernel<TNF, TO>, each tile, int8 and fp32 out) IMMA; every
    fp32 conv kernel (conv_f32_kernel<TPB, TN>), fp32 matmul kernel
    (matmul_f32_kernel<TNF>) and fp32 flash attention kernel
    (flash_f32_kernel<D>) FFMA and no tensor-core instruction (TF32 would
    break the reference's 1e-4). No other conv, matmul or flash kernel is
    left (the __dp4a conv and the one-block-a-slab int8 matmul are
    gone)."""
    funcs = _sass("conv_pipe")
    bf16 = [f for f in funcs if "conv_bf16_mma_kernel" in f]
    fp32 = [f for f in funcs if "conv_f32_kernel" in f]
    int8 = [f for f in funcs if "conv_s8_mma_kernel" in f]
    assert len(bf16) == len(TILES) and len(fp32) == len(TILES), sorted(funcs)
    assert len(int8) == 4 * len(TILES), sorted(funcs)
    assert len(funcs) == 6 * len(TILES), sorted(funcs)
    for f in bf16:
        assert "HMMA" in funcs[f], f
    for f in int8:
        assert "IMMA" in funcs[f] and "HMMA" not in funcs[f], f
    for f in fp32:
        assert "HMMA" not in funcs[f] and "FFMA" in funcs[f], f
    funcs = _sass("matmul_pipe")
    mm = [f for f in funcs if "matmul_bf16_kernel" in f]
    assert len(mm) == len(FC_FEATURES[torch.bfloat16]), sorted(funcs)
    for f in mm:
        assert "HMMA" in funcs[f], f
    mm = [f for f in funcs if "matmul_f32_kernel" in f]
    assert len(mm) == len(FC_FEATURES[torch.float32]), sorted(funcs)
    for f in mm:
        assert ("FFMA" in funcs[f] and "HMMA" not in funcs[f]
                and "IMMA" not in funcs[f]), f
    mm = [f for f in funcs if "matmul_s8_kernel" in f]
    assert len(mm) == 2 * len(FC_FEATURES[torch.int8]), sorted(funcs)
    for f in mm:
        assert "IMMA" in funcs[f] and "HMMA" not in funcs[f], f
    assert len(funcs) == sum(len(FC_FEATURES[t]) for t in (
        torch.bfloat16, torch.float32)) + 2 * len(FC_FEATURES[torch.int8]), \
        sorted(funcs)
    funcs = _sass("flash_attention")
    bf16 = [f for f in funcs if "flash_bf16_mma_kernel" in f]
    fp32 = [f for f in funcs if "flash_f32_kernel" in f]
    assert len(bf16) == len(HEAD_DIMS), sorted(funcs)
    assert len(fp32) == len(HEAD_DIMS), sorted(funcs)
    assert len(funcs) == len(bf16) + len(fp32), sorted(funcs)
    for f in bf16:
        assert "HMMA" in funcs[f], f
    for f in fp32:
        assert ("FFMA" in funcs[f] and "HMMA" not in funcs[f]
                and "IMMA" not in funcs[f]), f


# bf16 FC shapes that exercise the split-K cluster kernel: VGG-16 fc6, K
# not a multiple of the 64-wide chunk nor of the ranks' share, M > 8 with
# M % 8 != 0 (several grid rows, the last ragged), N % 8 != 0 (the element
# path) and N ragged against the 64- and 32-feature tiles
BF16_MATMUL_SHAPES = [(8, 25088, 4096), (8, 4096, 1000), (13, 1000, 200),
                      (20, 4104, 72), (3, 200, 1001), (8, 72, 8)]


def _bf16_fc_case(seed, M, K, N, dev):
    rng = np.random.default_rng(seed)
    return (_bf(rng.standard_normal((M, K)) * 0.3, dev),
            _bf(rng.standard_normal((K, N)) * 0.05, dev),
            _bf(rng.standard_normal(N), dev))


@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES + BF16_MATMUL_SHAPES)
@pytest.mark.parametrize("relu", [True, False])
def test_matmul_pipe_bf16_kernel_matches_plain(cuda, M, K, N, relu):
    x, w, b = _bf16_fc_case(21, M, K, N, cuda)
    n0, h0, s0 = _counts(matmul_pipe)
    _close_bf16(matmul_pipe(x, w, b, relu=relu),
                matmul_pipe_plain(x, w, b, relu=relu))
    assert _counts(matmul_pipe) == (n0, h0 + 1, s0)


def _force_split(monkeypatch, split):
    """Make the FC wrapper launch ``split`` (tnf, ranks) in every mode,
    whichever split :func:`fc_split` would choose."""
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.matmul_pipe"), "fc_split",
        lambda dtype, M, K, N, sms: split)


@pytest.mark.parametrize("split", [(tnf, r)
                                   for tnf in FC_FEATURES[torch.bfloat16]
                                   for r in (1, 2, 3, 5, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_matmul_pipe_bf16_every_split_matches_plain(cuda, monkeypatch, split,
                                                    M, K, N):
    """Each feature tile at 1 to 8 ranks a cluster, whichever split
    fc_split would choose."""
    _force_split(monkeypatch, split)
    x, w, b = _bf16_fc_case(25, M, K, N, cuda)
    _close_bf16(matmul_pipe(x, w, b, relu=True),
                matmul_pipe_plain(x, w, b, relu=True))


@pytest.mark.parametrize("M,K,N", [(8, 25088, 4096), (13, 1000, 200)])
def test_matmul_pipe_bf16_is_deterministic(cuda, M, K, N):
    """The split-K partial sums meet in a fixed order: two calls give the
    same bits."""
    x, w, b = _bf16_fc_case(26, M, K, N, cuda)
    y1, y2 = matmul_pipe(x, w, b), matmul_pipe(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("split", [(tnf, r)
                                   for tnf in FC_FEATURES[torch.float32]
                                   for r in (1, 2, 3, 5, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES + MATMUL_SHAPES
                         + [(5, 4098, 70)])
def test_matmul_pipe_fp32_every_split_matches_plain(cuda, monkeypatch, split,
                                                    M, K, N):
    """Each fp32 feature tile at 1 to 8 ranks a cluster (more ranks than K
    has chunks at K 200 and 256: some blocks sum nothing), whichever split
    fc_split would choose: M > 8 and ragged, N % 4 != 0 (w's element
    path), K % 4 != 0 (x's element path), N ragged against every tile."""
    _force_split(monkeypatch, split)
    rng = np.random.default_rng(27)
    x = _t(rng.standard_normal((M, K)) * 0.3, cuda)
    w = _t(rng.standard_normal((K, N)) * 0.05, cuda)
    b = _t(rng.standard_normal(N), cuda)
    _close(matmul_pipe(x, w, b, relu=True),
           matmul_pipe_plain(x, w, b, relu=True))


@pytest.mark.parametrize("M,K,N", [(8, 25088, 4096), (13, 1000, 200),
                                   (8, 4098, 1001)])
def test_matmul_pipe_fp32_is_deterministic(cuda, M, K, N):
    """The fp32 split-K partial sums meet in a fixed order (shuffle fold,
    then ranks, then warps): two calls give the same bits."""
    rng = np.random.default_rng(28)
    x = _t(rng.standard_normal((M, K)) * 0.3, cuda)
    w = _t(rng.standard_normal((K, N)) * 0.05, cuda)
    b = _t(rng.standard_normal(N), cuda)
    y1, y2 = matmul_pipe(x, w, b), matmul_pipe(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("shape", LRN_SHAPES)
def test_lrn_pwl_bf16_kernel_matches_plain(cuda, shape):
    """Within the bf16 tolerance and within one bf16 ulp of the plain
    version (fp32 inside, one rounding on store)."""
    rng = np.random.default_rng(22)
    x = _bf(rng.standard_normal(shape) * 4, cuda)
    n0, h0, s0 = _counts(lrn_pwl)
    got, want = lrn_pwl(x), lrn_pwl_plain(x)
    _close_bf16(got, want)
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    assert bool(((got.float() - w).abs() <= ulp).all())
    assert _counts(lrn_pwl) == (n0, h0 + 1, s0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_lrn_pwl_in_a_cuda_graph(cuda, dtype):
    """One capture of both AlexNet LRN shapes replays to the eager
    kernel's bits, on new inputs copied into the captured ones."""
    rng = np.random.default_rng(23)
    xs = [_t(rng.standard_normal(s) * 4, cuda).to(dtype)
          for s in ((8, 55, 55, 96), (8, 27, 27, 256))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in xs:
            lrn_pwl(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ys = [lrn_pwl(x) for x in xs]
    for x in xs:
        x.copy_(_t(rng.standard_normal(tuple(x.shape)) * 4, cuda).to(dtype))
    graph.replay()
    eager = [lrn_pwl(x) for x in xs]
    torch.cuda.synchronize()
    for y, e in zip(ys, eager):
        assert torch.equal(y, e)



@pytest.mark.parametrize("dtype,C", [(torch.float32, 4),
                                     (torch.float32, 3),
                                     (torch.bfloat16, 3)],
                         ids=["f32-vector", "f32-scalar", "bf16-scalar"])
def test_lrn_pwl_near_the_element_limit(cuda, dtype, C):
    """Just under 2^31 elements, the most the wrapper takes: the last
    block's thread indices pass 2^31, and the first and last pixels still
    equal the plain version (pixels are independent, so a slice is held
    against the plain version of that slice)."""
    P = (2 ** 31 - 1) // C
    gen = torch.Generator(device=cuda).manual_seed(24)
    x = torch.empty((1, 1, P, C), dtype=dtype, device=cuda)
    x.normal_(0.0, 4.0, generator=gen)
    y = lrn_pwl(x)
    for sl in (slice(0, 4096), slice(P - 4096, P)):
        got = y[:, :, sl]
        want = lrn_pwl_plain(x[:, :, sl].contiguous())
        if dtype == torch.float32:
            assert torch.equal(got, want)
        else:
            w = want.float()
            ulp = torch.ldexp(torch.ones_like(w),
                              torch.frexp(w).exponent - 8)
            assert bool(((got.float() - w).abs() <= ulp).all())
    del x, y
    torch.cuda.empty_cache()

def test_bf16_wrappers_refuse_mixed_dtypes(cuda):
    x = torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 4, 8), dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    before = [_counts(f) for f in (conv_pipe, lrn_pwl, matmul_pipe)]
    for args in ((x.float(), w, b), (x, w.float(), b), (x, w, b.float())):
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            conv_pipe(*args)
    xf, wf = x.reshape(16, 16), torch.zeros((16, 8), dtype=torch.bfloat16,
                                            device=cuda)
    for args in ((xf.float(), wf, b), (xf, wf.float(), b),
                 (xf, wf, b.float())):
        with pytest.raises(ValueError, match="float32 or all bfloat16"):
            matmul_pipe(*args)
    with pytest.raises(ValueError):
        lrn_pwl(x.half())                                  # fp16
    assert [_counts(f) for f in (conv_pipe, lrn_pwl, matmul_pipe)] == before


def test_bf16_forward_launches_only_the_bf16_modes(cuda):
    cfg = get_config("alexnet").smoke()
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(dtype="bfloat16")),
        generator=torch.Generator().manual_seed(0), device="cuda")
    x = torch.randn((2, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=torch.Generator().manual_seed(1))
    before = [_counts(f) for f in (conv_pipe, lrn_pwl, matmul_pipe)]
    logits = compiled.forward(x)
    after = [_counts(f) for f in (conv_pipe, lrn_pwl, matmul_pipe)]
    assert logits.dtype == torch.bfloat16
    assert [tuple(a - b for a, b in zip(x1, x0))
            for x1, x0 in zip(after, before)] == [(0, 5, 0), (0, 2, 0),
                                                  (0, 3, 0)]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_DTYPES = [torch.float32, torch.bfloat16]


def _randn(rng, shape, dtype, dev):
    return _t(rng.standard_normal(shape), dev).to(dtype)


def _close_attn(got, want):
    """Every element within rtol x (|want| + the RMS of want's row), rtol
    1e-4 in fp32 and 2e-2 in bf16: each output row (a head's query row)
    is held at its own scale, as chip_smoke.py holds them."""
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    rtol = 1e-4 if want.dtype == torch.float32 else 2e-2
    allow = rtol * (w.abs() + w.square().mean(-1, keepdim=True).sqrt())
    ratio = ((g - w).abs() / allow).max().item()
    assert ratio <= 1.0, f"an element is off by {ratio:.3f} x its allowance"


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,D", [
    (1, 2, 2, 32, 32, 16),
    (2, 4, 4, 64, 64, 32),
    (1, 1, 1, 128, 128, 64),
    (1, 4, 2, 100, 100, 128),      # GQA, S not a multiple of the 64 tile
    (2, 8, 2, 200, 200, 64),       # GQA g=4, ragged
    (1, 2, 1, 130, 130, 32),       # g=2, one query tile and a ragged one
    (1, 8, 2, 1000, 1000, 128),    # long, ragged, causal, g=4
    (1, 2, 2, 16, 16, 16),         # one ragged tile: warps past S
    (2, 4, 1, 300, 300, 16),       # g=4, ragged
    (2, 8, 2, 1000, 1000, 128),    # two batches of the long case
    # the edges of the fp32 kernel's 128-row query tile, GQA g=4
    (1, 8, 2, 127, 127, 64), (1, 8, 2, 129, 129, 64),
    (1, 8, 2, 257, 257, 64), (1, 8, 2, 127, 127, 128),
    (1, 8, 2, 129, 129, 128), (1, 8, 2, 257, 257, 128),
])
def test_flash_attention_kernel_matches_plain(cuda, B, Hq, Hkv, Sq, Sk, D,
                                              dtype):
    rng = np.random.default_rng(1)
    q = _randn(rng, (B, Hq, Sq, D), dtype, cuda)
    k = _randn(rng, (B, Hkv, Sk, D), dtype, cuda)
    v = _randn(rng, (B, Hkv, Sk, D), dtype, cuda)
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    n0 = getattr(flash_attention, counter)
    _close_attn(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert getattr(flash_attention, counter) == n0 + 1


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [(1, 8, 2, 1000, 128),
                                          (2, 4, 4, 300, 64),
                                          (1, 32, 8, 2048, 128)])
def test_flash_attention_fp32_is_deterministic(cuda, B, Hq, Hkv, S, D):
    """Each output row is one block's fixed sequence of FFMAs: two calls
    give the same bits."""
    rng = np.random.default_rng(4)
    q = _randn(rng, (B, Hq, S, D), torch.float32, cuda)
    k = _randn(rng, (B, Hkv, S, D), torch.float32, cuda)
    v = _randn(rng, (B, Hkv, S, D), torch.float32, cuda)
    o1, o2 = flash_attention(q, k, v), flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["f32", "bf16"])
def test_ops_attention_gqa_reads_head_h_over_g(cuda, dtype):
    """Query head h attends with KV head h // g (jnp.repeat's order): the
    kernel on the GQA inputs equals the oracle on repeated heads."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (1, 8, 96, 64), dtype, cuda)
    k = _randn(rng, (1, 2, 96, 64), dtype, cuda)
    v = _randn(rng, (1, 2, 96, 64), dtype, cuda)
    got = ops.attention(q, k, v)
    _close_attn(got, ops.attention(q, k, v, use_kernels=False))
    want = flash_attention(q, k.repeat_interleave(4, 1),
                           v.repeat_interleave(4, 1))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_flash_attention_is_causal_on_the_card(cuda):
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, (1, 2, 96, 32), torch.float32, cuda)
               for _ in range(3))
    o1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 70:] = 99.0
    v2[:, :, 70:] = -99.0
    o2 = flash_attention(q, k2, v2)
    torch.cuda.synchronize()
    assert torch.equal(o1[:, :, :70], o2[:, :, :70])


def _decode_inputs(rng, B, S, HKV, G, D, dtype, dev):
    return (_randn(rng, (B, HKV, G, D), dtype, dev),
            _randn(rng, (B, S, HKV, D), dtype, dev),
            _randn(rng, (B, S, HKV, D), dtype, dev),
            _randn(rng, (B, HKV, D), dtype, dev),
            _randn(rng, (B, HKV, D), dtype, dev))


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,HKV,G,D,pos", [
    (1, 32, 2, 2, 16, 7),
    (2, 64, 4, 2, 16, 37),
    (2, 128, 2, 4, 32, 127),       # the last slot
    (1, 64, 1, 8, 16, 0),          # the first slot
    (2, 300, 8, 4, 128, 299),      # S not a multiple of the 64-slot tile
    (1, 300, 2, 4, 128, 130),
    (1, 200, 2, 3, 64, 199),
    (1, 4096, 8, 4, 128, 4095),    # Qwen3-8B at B 1: many splits a head
])
@pytest.mark.parametrize("pos_on_device", [False, True], ids=["int", "dev"])
def test_decode_attention_kernel_matches_plain(cuda, B, S, HKV, G, D, pos,
                                               dtype, pos_on_device):
    rng = np.random.default_rng(4)
    q, kc, vc, nk, nv = _decode_inputs(rng, B, S, HKV, G, D, dtype, cuda)
    p = (torch.tensor(pos, dtype=torch.int32, device=cuda)
         if pos_on_device else pos)
    kp, vp = kc.clone(), vc.clone()
    o_plain, kp, vp = decode_attention_plain(q, kp, vp, nk, nv, p)
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    n0 = getattr(decode_attention, counter)
    o, k_out, v_out = decode_attention(q, kc, vc, nk, nv, p)
    assert getattr(decode_attention, counter) == n0 + 1
    assert k_out is kc and v_out is vc                  # in place
    _close_attn(o, o_plain)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


def _force_decode_split(monkeypatch, P):
    """Make the decode wrapper launch P blocks a (batch, KV head), whichever
    split :func:`decode_split` would choose."""
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.kernels.decode_attention"), "decode_split",
        lambda dtype, B, HKV, S, sms: P)


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("pos_on_device", [False, True], ids=["int", "dev"])
@pytest.mark.parametrize("P", [1, 2, 3, 5, 8, 13])
@pytest.mark.parametrize("B,S,HKV,G,D,pos", [
    (2, 300, 2, 3, 64, 0),          # one slot: every split but one empty
    (2, 300, 2, 3, 64, 127),        # a tile edge: two whole tiles
    (2, 300, 2, 3, 64, 128),        # one slot into the third tile
    (2, 300, 2, 3, 64, 299),        # the last slot of a ragged cache
    (1, 200, 2, 8, 128, 0),         # G 8 (the 8-row kernel), ragged S
    (1, 200, 2, 8, 128, 63),
    (1, 200, 2, 8, 128, 64),
    (1, 200, 2, 8, 128, 199),
])
def test_decode_attention_every_split_matches_plain(cuda, monkeypatch, P, B,
                                                    S, HKV, G, D, pos, dtype,
                                                    pos_on_device):
    """Each split P, more shares than tiles (13, and 5 and 8 at small pos)
    included: slot pos on a share's edge, at 0 and at S - 1, an int or a
    device pos. The caches bit-equal to the plain version's after the
    write; o within the attention allowance."""
    _force_decode_split(monkeypatch, P)
    rng = np.random.default_rng(7)
    q, kc, vc, nk, nv = _decode_inputs(rng, B, S, HKV, G, D, dtype, cuda)
    p = (torch.tensor(pos, dtype=torch.int32, device=cuda)
         if pos_on_device else pos)
    kp, vp = kc.clone(), vc.clone()
    o_plain, kp, vp = decode_attention_plain(q, kp, vp, nk, nv, p)
    o, _, _ = decode_attention(q, kc, vc, nk, nv, p)
    _close_attn(o, o_plain)
    assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,pos", [(8, 4096, 4095), (1, 4096, 2000),
                                     (2, 300, 299)])
def test_decode_attention_is_deterministic(cuda, B, S, pos, dtype):
    """The splits' partials meet in a fixed order (row groups, warps, then
    splits): two calls on the same inputs give the same bits."""
    rng = np.random.default_rng(8)
    q, kc, vc, nk, nv = _decode_inputs(rng, B, S, 8, 4, 128, dtype, cuda)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    o1, _, _ = decode_attention(q, kc, vc, nk, nv, p)
    o2, _, _ = decode_attention(q, kc, vc, nk, nv, p)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


@pytest.mark.parametrize("dtype", ATTN_DTYPES, ids=["f32", "bf16"])
def test_decode_attention_in_a_cuda_graph(cuda, dtype):
    """One capture with a device pos; between replays pos advances and new
    q, new_k and new_v are copied into the captured inputs. Each replay
    matches the plain version at its pos, the caches bit-equal: the split
    never depends on pos, and the shares are worked out on the card."""
    rng = np.random.default_rng(9)
    B, S, HKV, G, D = 2, 1000, 2, 4, 64
    q, kc, vc, nk, nv = _decode_inputs(rng, B, S, HKV, G, D, dtype, cuda)
    pos = torch.zeros((), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, kc, vc, nk, nv, pos)     # builds; writes slot 0
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, _, _ = decode_attention(q, kc, vc, nk, nv, pos)
    kp, vp = kc.clone(), vc.clone()
    for step in (0, 1, 63, 64, 65, 500, 999):
        for t in (q, nk, nv):
            t.copy_(_randn(rng, tuple(t.shape), dtype, cuda))
        pos.fill_(step)
        graph.replay()
        want, kp, vp = decode_attention_plain(q, kp, vp, nk, nv, step)
        _close_attn(o, want)
        assert torch.equal(kc, kp) and torch.equal(vc, vp)


@pytest.mark.parametrize("pos", [0, 127])
def test_decode_attention_writes_slot_pos_only(cuda, pos):
    rng = np.random.default_rng(5)
    q, kc, vc, nk, nv = _decode_inputs(rng, 2, 128, 2, 4, 64,
                                       torch.bfloat16, cuda)
    k0, v0 = kc.clone(), vc.clone()
    decode_attention(q, kc, vc, nk, nv, pos)
    torch.cuda.synchronize()
    others = [s for s in range(128) if s != pos]
    assert torch.equal(kc[:, others], k0[:, others])
    assert torch.equal(vc[:, others], v0[:, others])
    assert torch.equal(kc[:, pos], nk) and torch.equal(vc[:, pos], nv)


def test_decode_attention_ignores_stale_future_slots(cuda):
    rng = np.random.default_rng(6)
    q, kc, vc, nk, nv = _decode_inputs(rng, 1, 200, 2, 2, 64,
                                       torch.float32, cuda)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 100:] = float("inf")            # never read past pos
    vc2[:, 100:] = float("nan")
    o1, _, _ = decode_attention(q, kc, vc, nk, nv, 90)
    o2, _, _ = decode_attention(q, kc2, vc2, nk, nv, 90)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 4, 32, 64), device=cuda)
    k = torch.zeros((1, 2, 32, 64), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q.half(), k.half(), k.half())       # fp16
    with pytest.raises(ValueError):
        flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError):
        flash_attention(q, k.transpose(2, 3), k)             # shape
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 3, 32, 64), device=cuda),
                        torch.zeros((1, 3, 32, 64), device=cuda))  # Hq % Hkv
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        k[..., :48].contiguous())            # head width 48
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros((1, 2, 40, 64), device=cuda),
                        torch.zeros((1, 2, 40, 64), device=cuda))  # Sk != Sq
    qd = torch.zeros((1, 2, 4, 64), device=cuda)
    kc = torch.zeros((1, 16, 2, 64), device=cuda)
    nk = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(ValueError):
        decode_attention(qd.half(), kc.half(), kc.half(), nk.half(),
                         nk.half(), 3)                       # fp16
    with pytest.raises(ValueError):
        decode_attention(qd, kc, kc.clone(), nk, nk, 16)     # pos >= S
    with pytest.raises(ValueError):
        decode_attention(qd, kc, kc.clone(), nk, nk,
                         torch.tensor(3, device=cuda))       # int64 pos
    with pytest.raises(ValueError):
        decode_attention(torch.zeros((1, 2, 9, 64), device=cuda), kc,
                         kc.clone(), nk, nk, 3)              # G > 8


# ---------------------------------------------------------------------------
# plans (the DSE): every fitting plan launches and equals the plain version
# ---------------------------------------------------------------------------

def test_smem_tables_equal_what_the_kernels_request(cuda):
    from repro_torch.kernels import conv_pipe as cp
    from repro_torch.kernels import matmul_pipe as mp
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for cg in ((16, 3) if dtype == torch.int8 else (16,)):
            for tp, tn in TILES:
                assert cp.conv_smem(dtype, tp, tn, cg) == cp.library_smem(
                    dtype, tp, tn, cg), (dtype, tp, tn, cg)
        for tnf in FC_FEATURES[dtype]:
            assert mp.fc_smem(dtype, tnf) == mp.library_smem(dtype, tnf)
    assert cp.library_smem(torch.float32, 32, 64, 16) == -1
    assert mp.library_smem(torch.bfloat16, 128) == -1


PLAN_MODES = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}


@pytest.mark.parametrize("mode", sorted(PLAN_MODES))
@pytest.mark.parametrize("B,H,C,K,M,pad,pool,pool_k,pool_s,groups", [
    (2, 27, 16, 3, 96, 1, "max", 3, 2, 2),
    (3, 20, 3, 3, 70, 1, None, 2, 2, 1)])
def test_every_fitting_conv_plan_equals_plain(cuda, mode, B, H, C, K, M, pad,
                                              pool, pool_k, pool_s, groups):
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(40)
    shape = autotune.ConvShape(h=H, w=H, c=C, kh=K, kw=K, m=M, pad=pad,
                               groups=groups, pool=pool, pool_k=pool_k,
                               pool_s=pool_s, b=B,
                               dtype=str(PLAN_MODES[mode])[6:])
    kw = dict(pad=pad, pool=pool, pool_k=pool_k, pool_s=pool_s,
              groups=groups)
    if mode == "int8":
        x = torch.from_numpy(rng.integers(-127, 128, (B, H, H, C),
                                          dtype=np.int8)).to(cuda)
        w = torch.from_numpy(rng.integers(-127, 128, (K, K, C // groups, M),
                                          dtype=np.int8)).to(cuda)
        scale, b = _requant(rng, M, K * K * C // groups, cuda)
        kw.update(scale=scale, out_scale=OUT_SCALE)
    else:
        x = _t(rng.standard_normal((B, H, H, C)), cuda)
        w = _t(rng.standard_normal((K, K, C // groups, M)) * 0.2, cuda)
        b = _t(rng.standard_normal(M), cuda)
        x, w, b = (t.to(PLAN_MODES[mode]) for t in (x, w, b))
    want = conv_pipe_plain(x, w, b, **kw)
    plans = autotune.enumerate_plans(shape)
    assert len(plans) == 4
    for plan in plans:
        got = conv_pipe(x, w, b, tile=plan.tile, **kw)
        if mode == "int8":
            _equal(got, want)
        elif mode == "bf16":
            _close_bf16(got, want)
        else:
            _close(got, want)


@pytest.mark.parametrize("mode", sorted(PLAN_MODES))
@pytest.mark.parametrize("M,K,N", [(8, 3000, 200), (13, 1000, 70)])
def test_every_fitting_fc_plan_equals_plain(cuda, mode, M, K, N):
    from repro_torch.kernels import autotune
    rng = np.random.default_rng(41)
    shape = autotune.GemmShape(m=M, k=K, n=N,
                               dtype=str(PLAN_MODES[mode])[6:])
    if mode == "int8":
        x = torch.from_numpy(rng.integers(-127, 128, (M, K),
                                          dtype=np.int8)).to(cuda)
        w = torch.from_numpy(rng.integers(-127, 128, (K, N),
                                          dtype=np.int8)).to(cuda)
        scale, b = _requant(rng, N, K, cuda)
        kw = dict(scale=scale, out_scale=OUT_SCALE, relu=True)
    else:
        x = _t(rng.standard_normal((M, K)) * 0.3, cuda).to(PLAN_MODES[mode])
        w = _t(rng.standard_normal((K, N)) * 0.05, cuda).to(PLAN_MODES[mode])
        b = _t(rng.standard_normal(N), cuda).to(PLAN_MODES[mode])
        kw = dict(relu=True)
    want = matmul_pipe_plain(x, w, b, **kw)
    plans = autotune.enumerate_gemm_plans(shape)
    assert len(plans) == sum(min(8, -(-K // fc_chunk(PLAN_MODES[mode], f)))
                             for f in FC_FEATURES[PLAN_MODES[mode]])
    for plan in plans:
        got = matmul_pipe(x, w, b, split=plan.split, **kw)
        if mode == "int8":
            _equal(got, want)
        elif mode == "bf16":
            _close_bf16(got, want)
        else:
            _close(got, want)


def test_plans_that_do_not_fit_raise(cuda):
    x = torch.zeros((1, 16, 16, 8), device=cuda)
    w = torch.zeros((3, 3, 8, 16), device=cuda)
    b = torch.zeros(16, device=cuda)
    n0 = conv_pipe.launches
    for tile in ((64, 64, 5, 5), (96, 64, 1, 1), (64, 32, 1, 1)):
        with pytest.raises(ValueError):
            conv_pipe(x, w, b, pad=1, pool="max", tile=tile)
    with pytest.raises(ValueError):
        conv_pipe(x, w, b, pad=1, tile=(64, 64, 2, 2))   # no pool: (1, 1)
    xf, wf = torch.zeros((8, 64), device=cuda), torch.zeros((64, 8),
                                                            device=cuda)
    m0 = matmul_pipe.launches
    for split in ((64, 9), (64, 0), (48, 1), (64, 3)):  # 64 k: 2 chunks
        with pytest.raises(ValueError):
            matmul_pipe(xf, wf, split=split)
    assert conv_pipe.launches == n0 and matmul_pipe.launches == m0


@pytest.mark.parametrize("kind", ["conv", "gemm"])
def test_measure_record_is_a_positive_card_time(cuda, kind):
    from repro_torch.kernels import autotune
    from repro_torch.obs import profiler
    if kind == "conv":
        shape = autotune.ConvShape(h=28, w=28, c=64, kh=3, kw=3, m=64,
                                   pad=1, pool="max", b=8)
        plan = autotune.best_plan(shape)
    else:
        shape = autotune.GemmShape(m=8, k=4096, n=1000, dtype="int8")
        plan = autotune.best_gemm_plan(shape)
    before = autotune.measure_stats()[f"{kind}_measured"]
    rec = profiler.measure_record(kind, shape, plan, opts=profiler.
                                  MeasureOptions(repeats=3, iters=5))
    assert 0 < rec["t_measured"] < 1 and np.isfinite(rec["t_measured"])
    assert autotune.measure_stats()[f"{kind}_measured"] == before + 3
    assert profiler.backend_fingerprint()["timer"] == "cuda events"


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8-s8", "int8-f32"])
def test_matmul_pipe_without_bias_equals_zero_bias(cuda, mode):
    rng = np.random.default_rng(42)
    if mode.startswith("int8"):
        x = torch.from_numpy(rng.integers(-127, 128, (8, 1000),
                                          dtype=np.int8)).to(cuda)
        w = torch.from_numpy(rng.integers(-127, 128, (1000, 200),
                                          dtype=np.int8)).to(cuda)
        scale, _ = _requant(rng, 200, 1000, cuda)
        kw = dict(scale=scale, relu=True,
                  out_scale=OUT_SCALE if mode == "int8-s8" else None)
        zero = torch.zeros(200, device=cuda)
    else:
        dt = torch.float32 if mode == "fp32" else torch.bfloat16
        x = _t(rng.standard_normal((8, 1000)) * 0.3, cuda).to(dt)
        w = _t(rng.standard_normal((1000, 200)) * 0.05, cuda).to(dt)
        kw = dict(relu=True)
        zero = torch.zeros(200, device=cuda, dtype=dt)
    got = matmul_pipe(x, w, **kw)
    _equal(got, matmul_pipe(x, w, zero, **kw))
    _equal(matmul_pipe_plain(x, w, **kw), matmul_pipe_plain(x, w, zero, **kw))
    if not mode.startswith("int8"):
        _equal(ops.fc(x, w, relu=True), got)


# -- the fleet's stage streams and the artifact on the card ----------------

FLEET_MODES = {"fp32": {}, "bf16": {"dtype": "bfloat16"},
               "int8": {"quant": "int8"}}


@pytest.mark.parametrize("placement", [(1, 3, 4), (2, 2, 2), (3, 1, 0)],
                         ids=["pp", "hybrid", "dp"])
@pytest.mark.parametrize("mode", sorted(FLEET_MODES))
def test_stage_streams_equal_a_sequential_run(cuda, mode, placement):
    """The compiled placement's forward (replicas and stages on CUDA
    streams) and its serve give the plain fold's logits and predictions
    bit for bit: the same kernels in another order of streams."""
    from repro_torch.launch.serve_cnn import synthetic_requests
    from repro_torch.pipeline import Placement, Serving
    R, S, M = placement
    cfg = get_config("alexnet").smoke()
    c = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(**FLEET_MODES[mode]),
        placement=Placement(replicas=R, pp_stages=S, microbatches=M),
        serving=Serving(batch=8, retries=1)),
        generator=torch.Generator().manual_seed(4), device=cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8 * R, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(
            np.float32)).to(cuda)
    with torch.inference_mode():
        fold = c.model(x.to(c.model.in_dtype))
    if S > 1:
        assert torch.equal(c.forward(x), fold)
    reqs = synthetic_requests(8 * R + 3, cfg.input_hw, cfg.input_ch, 1e4)
    rep = c.serve(reqs)
    imgs = torch.from_numpy(np.stack([r.image for r in reqs])).to(cuda)
    with torch.inference_mode():
        want = torch.cat([c.model(imgs[i:i + 8].to(c.model.in_dtype))
                          .float().argmax(-1) for i in range(0, len(reqs),
                                                             8)]).tolist()
    done = sorted(rep.completions, key=lambda d: d.rid)
    assert [d.pred for d in done] == want
    assert all(d.status == "ok" for d in done)


def test_stage_boundaries_survive_the_allocator(cuda):
    """A boundary tensor freed on the host while a slower stage still
    reads it: its memory must not go to the next microbatch's boundary
    (``record_stream``). Stage 1 sleeps before it reads; stage 0 writes
    each microbatch's new boundary meanwhile."""
    from repro_torch.parallel.pipeline_par import gpipe_schedule

    def stage(s, h):
        if s == 1:
            torch.cuda._sleep(2_000_000)
        return h + 1.0

    micro = [torch.full((1 << 20,), float(m), device=cuda)
             for m in range(8)]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    out = gpipe_schedule(stage, micro, 2, streams=streams)
    del micro
    junk = [torch.full((1 << 20,), -7.0, device=cuda) for _ in range(8)]
    torch.cuda.synchronize()
    for m, o in enumerate(out):
        assert torch.equal(o, torch.full_like(o, m + 2.0)), m
    del junk


@pytest.mark.parametrize("mode", sorted(FLEET_MODES))
def test_artifact_saved_on_the_card_reloads_equal(cuda, mode, tmp_path):
    from repro_torch.kernels import autotune
    from repro_torch.pipeline import CompiledCNN
    cfg = get_config("vgg16").smoke()
    c = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(**FLEET_MODES[mode])),
        generator=torch.Generator().manual_seed(6), device=cuda)
    c.save(tmp_path / "a1")
    autotune.clear_registry()
    autotune.reset_sweep_stats()
    c2 = CompiledCNN.load(tmp_path / "a1")
    st = autotune.sweep_stats()
    assert st["conv_sweeps"] == 0 and st["gemm_sweeps"] == 0
    assert c2.device.type == "cuda"
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(
            np.float32)).to(cuda)
    assert torch.equal(c2.forward(x), c.forward(x))
    c2.save(tmp_path / "a2")
    for f in ("manifest.json", "plan_table.json"):
        assert (tmp_path / "a1" / f).read_bytes() == \
            (tmp_path / "a2" / f).read_bytes()


# -- the continuous scheduler's slot forward on the card (slice 7) ---------

# the launch counter of each AlexNet kernel a forward runs, by mode
SLOT_COUNTERS = {"fp32": ("launches", "launches", "launches"),
                 "bf16": ("launches_bf16", "launches_bf16", "launches_bf16"),
                 "int8": ("launches_s8", "launches_s8", "launches_s8")}


def _slot_compile(cuda, mode):
    from repro_torch.pipeline import (AutoscalePolicy, Placement, Serving)
    return compile_cnn(get_config("alexnet").smoke(), ExecutionSpec(
        precision=Precision(**FLEET_MODES[mode]),
        placement=Placement(replicas=2),
        serving=Serving(batch=8, clock="modeled", scheduler="continuous",
                        retries=2, steal_threshold=1,
                        autoscale=AutoscalePolicy(min_replicas=1,
                                                  max_replicas=4))),
        generator=torch.Generator().manual_seed(7), device=cuda)


def _burst(cfg, n=45):
    from repro_torch.launch.serve_cnn import synthetic_requests
    reqs = synthetic_requests(n, cfg.input_hw, cfg.input_ch, 1e7)
    for i in range(0, n, 5):
        reqs[i].cost = 4.0
    return reqs


@pytest.mark.parametrize("mode", sorted(FLEET_MODES))
def test_slot_forward_preds_equal_the_compiled_forward(cuda, mode):
    """Version 0's slot forward (one copy of the padded group to the card,
    the run dtype, argmax of the fp32-widened logits) gives the compiled
    forward's predictions, padding rows included."""
    c = _slot_compile(cuda, mode)
    imgs = np.random.default_rng(8).standard_normal(
        (8, 67, 67, 3)).astype(np.float32)
    imgs[5:] = 0.0
    got = c.engine._slot_fn(0)(imgs)
    want = c.forward(imgs).float().argmax(-1).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(FLEET_MODES))
def test_continuous_run_launches_one_forward_an_admission_group(cuda, mode):
    """Steals, autoscaling and stragglers on the modelled clock with the
    kernels on the card: the counters grow by exactly admission groups x
    (5 conv, 2 lrn, 3 matmul), and every ok prediction is the forward's."""
    from repro_torch.kernels import conv_pipe as cpm
    from repro_torch.kernels import lrn_pwl as lpm
    from repro_torch.kernels import matmul_pipe as mpm
    c = _slot_compile(cuda, mode)
    tr = c.engine.t_round_model
    c.engine.autoscale = dataclasses.replace(c.engine.autoscale,
                                             interval=tr / 2)
    reqs = _burst(c.cfg)
    mods = (cpm.conv_pipe, lpm.lrn_pwl, mpm.matmul_pipe)
    for m, attr in zip(mods, SLOT_COUNTERS[mode]):
        setattr(m, attr, 0)
    rep = c.serve(reqs)
    torch.cuda.synchronize()
    got = [getattr(m, attr) for m, attr in zip(mods, SLOT_COUNTERS[mode])]
    groups = c.engine.admission_groups
    assert groups >= -(-len(reqs) // 8) and got == [5 * groups,
                                                    2 * groups, 3 * groups]
    assert rep.n_steals > 0
    imgs = torch.from_numpy(np.stack([r.image for r in reqs])).to(cuda)
    want = torch.cat([c.forward(imgs[i:i + 8]).float().argmax(-1)
                      for i in range(0, len(reqs), 8)]).tolist()
    done = sorted(rep.completions, key=lambda d: d.rid)
    assert [d.rid for d in done] == list(range(len(reqs)))
    assert all(d.pred == want[d.rid] for d in done if d.status == "ok")


def test_modelled_trace_is_byte_identical_on_the_card(cuda):
    """Two executed runs of one compile on the modelled clock write the
    same trace and metrics bytes: the kernels' wall time never reaches the
    clock."""
    from repro_torch.obs import MetricsRegistry, TraceRecorder
    c = _slot_compile(cuda, "fp32")
    c.engine.autoscale = dataclasses.replace(
        c.engine.autoscale, interval=c.engine.t_round_model / 2)
    docs = []
    for _ in range(2):
        trace, metrics = TraceRecorder(), MetricsRegistry()
        c.serve(_burst(c.cfg), trace=trace, metrics=metrics)
        docs.append((trace.to_json(), metrics.to_json()))
    assert docs[0] == docs[1] and '"steal"' in docs[0][0]


# ---------------------------------------------------------------------------
# the LM serving path (slice 8a): plain PyTorch on the card, as the JAX LM
# is plain XLA, so it launches none of the port's kernels
# ---------------------------------------------------------------------------

LM_FAMILIES = {"dense": "qwen3_8b", "vlm": "internvl2_26b",
               "audio": "musicgen_medium", "moe": "dbrx_132b",
               "hybrid": "zamba2_1p2b", "ssm": "xlstm_125m"}


def _kernel_launches():
    return {(f.__name__, a): getattr(f, a)
            for f in (conv_pipe, lrn_pwl, matmul_pipe, flash_attention,
                      decode_attention)
            for a in ("launches", "launches_bf16", "launches_s8")
            if hasattr(f, a)}


def _cache_leaves(cache):
    """A DecodeCache's tensors in field order."""
    for field in cache:
        if isinstance(field, torch.Tensor):
            yield field
        else:
            yield from field


@pytest.mark.parametrize("family", sorted(LM_FAMILIES))
def test_lm_smoke_model_on_the_card_matches_the_cpu(cuda, family):
    """Each family's smoke model, the same parameters on the card and on
    the CPU (fp32, TF32 off): forward, prefill and one decode step within
    1e-4 x max(1, max|cpu|), every cache leaf too; greedy generation gives
    the CPU's tokens; no kernel launch counter moves."""
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    cfg = get_config(LM_FAMILIES[family]).smoke()
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p_gpu = lm.tree_map(lambda a: a.to(cuda), p_cpu)
    rng = np.random.default_rng(0)
    F = cfg.frontend_len if cfg.frontend else 0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20 - F)))
    fe = (torch.from_numpy(rng.standard_normal((2, F, cfg.d_model))
                           .astype(np.float32) * 0.02) if F else None)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 1)))
    n0 = _kernel_launches()

    def run(p, dev):
        mv = (lambda t: None if t is None else t.to(dev))
        out = [lm.forward(p, mv(toks), cfg, mv(fe))]
        lp, cache = lm.prefill(p, mv(toks), cfg, 32, mv(fe))
        ld, cache2 = lm.decode_step(p, mv(nxt), cache, cfg)
        return out + [lp, ld], [cache, cache2]

    def close(got, want):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got.cpu() - want).abs().max().item() <= tol

    (outs_g, caches_g), (outs_c, caches_c) = run(p_gpu, cuda), run(p_cpu,
                                                                  "cpu")
    for g, c in zip(outs_g, outs_c):
        close(g, c)
    for cg, cc in zip(caches_g, caches_c):
        for a, b in zip(_cache_leaves(cg), _cache_leaves(cc)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if b.numel():
                close(a.float(), b.float())
    scfg = dataclasses.replace(cfg, frontend=None, frontend_len=0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10)))
    want = generate(p_cpu, prompts, scfg, 6, 24)
    got = generate(p_gpu, prompts.to(cuda), scfg, 6, 24)
    assert torch.equal(got.cpu(), want)
    assert _kernel_launches() == n0


# ---------------------------------------------------------------------------
# The LM training path (slice 8b) on the card: plain PyTorch, as JAX's
# train_step is plain XLA, so it launches none of the port's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(LM_FAMILIES))
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, family):
    """One ``train_step`` of each family's smoke model (fp32, TF32 off)
    from the same state on the card and on the CPU: the loss, every
    gradient leaf and every new parameter and moment within 1e-4 x
    max(1, max|cpu|) (a parameter moves by lr x sign(g) on Adam's first
    step: lr 1e-4 keeps a sign flip at g near 0 inside that); no kernel
    launch counter moves."""
    from repro_torch.ckpt.checkpoint import tree_flatten, tree_unflatten
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import steps
    cfg = get_config(LM_FAMILIES[family]).smoke()
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=0)
    rng = np.random.default_rng(1)
    F = cfg.frontend_len if cfg.frontend else 0
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    if F:
        batch["frontend_embed"] = (rng.standard_normal(
            (2, F, cfg.d_model)) * 0.02).astype(np.float32)
    n0 = _kernel_launches()

    def run(dev):
        st = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    ocfg, "cpu")
        st = tree_unflatten(st, [a.to(dev) for a in tree_flatten(st)[0]])
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, grads = steps.loss_and_grads(st.params, b, cfg)
        new, metrics = steps.train_step(st, b, cfg, ocfg)
        return loss, grads, new, metrics

    def close(got, want):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got.cpu().float() - want.float()).abs().max().item() <= tol

    lg, gg, sg, mg = run(cuda)
    lc, gc, sc, mc = run("cpu")
    close(lg, lc)
    close(mg["grad_norm"], mc["grad_norm"])
    for (_, a), (_, b) in zip(lm.tree_leaves(gg), lm.tree_leaves(gc)):
        close(a, b)
    for a, b in zip(tree_flatten(sg)[0], tree_flatten(sc)[0]):
        close(a, b)
    assert _kernel_launches() == n0


def test_lm_loss_falls_on_the_card(cuda, tmp_path):
    """JAX's own training check on the card: 30 smoke steps on the Markov
    stream lower the loss by at least 0.3, and no kernel is launched."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import LoopConfig, ResilientLoop
    cfg = get_config("qwen3_8b").smoke()
    n0 = _kernel_launches()
    out = ResilientLoop(
        cfg, LoopConfig(total_steps=30, ckpt_every=100,
                        ckpt_dir=str(tmp_path), log_every=100),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8),
        ocfg=AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100),
        device=cuda).run()
    losses = [m["loss"] for m in out["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses
    assert _kernel_launches() == n0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_checkpoint_from_the_card_reloads_equal(cuda, tmp_path, dtype):
    """A train state on the card, written and read back onto the card:
    every leaf ``torch.equal`` in its dtype and on the card."""
    from repro_torch.ckpt.checkpoint import (load_checkpoint,
                                             save_checkpoint, tree_flatten)
    from repro_torch.train import steps
    cfg = dataclasses.replace(get_config("zamba2_1p2b").smoke(), dtype=dtype)
    st = steps.init_train_state(cfg, torch.Generator(cuda).manual_seed(0))
    save_checkpoint(str(tmp_path), 3, st)
    like = steps.init_train_state(cfg, torch.Generator(cuda).manual_seed(1))
    got, step = load_checkpoint(str(tmp_path), like)
    assert step == 3
    for a, b in zip(tree_flatten(got)[0], tree_flatten(st)[0]):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)
