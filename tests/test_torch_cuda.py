"""The port's CUDA kernels against their plain versions, on the card.

Every test takes the ``cuda`` fixture, which skips without a CUDA device.
This file imports no JAX, so it runs on the card without the repository's
conftest:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: conv/matmul ``|kernel - plain| <= 1e-4 * max(1, max|plain|)``
(fp32 sums in another order, TF32 off on the plain side); LRN
``rtol=1e-5, atol=1e-6`` (same operations, same rounding).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.conv_pipe import conv_pipe, conv_pipe_plain
from repro_torch.kernels.lrn_pwl import lrn_pwl, lrn_pwl_plain
from repro_torch.kernels.matmul_pipe import matmul_pipe, matmul_pipe_plain


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


@pytest.mark.parametrize(
    "B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups",
    [
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
    ])
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


@pytest.mark.parametrize("M,K,N", [
    (64, 128, 32), (100, 300, 70), (1, 256, 1000), (64, 9216, 128),
    (8, 9216, 4096), (8, 300, 1001)])
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


@pytest.mark.parametrize("shape", [(2, 6, 6, 8), (2, 6, 6, 32),
                                   (2, 6, 6, 96), (1, 5, 7, 3),
                                   (8, 27, 27, 256)])
def test_lrn_pwl_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal(shape) * 4, cuda)
    n0 = lrn_pwl.launches
    got, want = lrn_pwl(x), lrn_pwl_plain(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
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
