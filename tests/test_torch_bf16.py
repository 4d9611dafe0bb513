"""The port's bf16 path against the JAX package's, on the CPU.

Inputs are made with numpy from a seed, rounded to bf16 the same way on
both sides, and fed to both packages. On a CPU tensor each port wrapper
runs its kernel's plain version, which computes in fp32 and rounds once
to bf16, as the CUDA kernels do. The Pallas ``conv_pipe`` cannot run under
this jax (no ``pl.Unblocked``), so the conv is held against the JAX oracle
``conv_pipe_ref`` in bf16, which rounds twice (conv, then ``+ b``);
``matmul_pipe`` and ``lrn_pwl`` are held against the Pallas kernels in
interpret mode, to one bf16 ulp. Tolerance elsewhere: the reference's bf16
``rtol = atol = 2e-2`` (``tests/test_kernels.py:17-19``), and logits
within ``2e-2 * max|logit|``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.lrn_pwl import lrn_pwl as jax_lrn_pwl
from repro.kernels.matmul_pipe import matmul_pipe as jax_matmul_pipe
from repro_torch.configs import CNN_IDS, get_config
from repro_torch.kernels import ref
from repro_torch.kernels.conv_pipe import conv_pipe, conv_pipe_plain
from repro_torch.kernels.lrn_pwl import lrn_pwl
from repro_torch.kernels.matmul_pipe import matmul_pipe
from repro_torch.launch.serve_cnn import synthetic_requests
from repro_torch.models.cnn import init_cnn_params, params_from_jax
from repro_torch.pipeline import (ExecutionSpec, Precision, Serving,
                                  compile_cnn)

BF16 = dict(rtol=2e-2, atol=2e-2)        # tests/test_kernels.py:17-19, bf16
LOGIT_RTOL = 2e-2


def _both(a):
    """One numpy array as a JAX and a torch bf16 array (both round to
    nearest even, so they hold the same values)."""
    a = np.ascontiguousarray(a, np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a.copy()).to(torch.bfloat16))


def _np(t):
    if isinstance(t, torch.Tensor):
        assert t.dtype == torch.bfloat16
        return t.float().numpy()
    assert t.dtype == jnp.bfloat16
    return np.asarray(t, np.float32)


def _ulps(got, want):
    """The worst |got - want| in units of the bf16 spacing at |want|
    (8 significant bits): 0 equal, 1 one rounding apart."""
    g, w = _np(got), _np(want)
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float((np.abs(g - w) / ulp).max())


CONV_SHAPES = [                        # tests/test_kernels.py:28-35, + groups
    (1, 8, 3, 3, 8, 1, 1, None, 2, 2, 1),
    (2, 16, 4, 3, 16, 1, 0, "max", 2, 2, 1),
    (1, 23, 3, 5, 8, 2, 2, "avg", 3, 2, 1),
    (1, 27, 3, 11, 16, 4, 0, "max", 3, 2, 1),   # AlexNet conv1 geometry
    (2, 14, 8, 1, 8, 1, 0, None, 2, 2, 1),       # 1x1 conv
    (1, 12, 6, 3, 12, 3, 1, None, 2, 2, 1),      # stride 3
    (2, 13, 16, 3, 24, 1, 1, None, 2, 2, 2),     # grouped (conv4)
    (2, 13, 8, 5, 16, 1, 2, None, 2, 2, 2),      # grouped 5x5 (conv2)
    (2, 13, 16, 3, 16, 1, 1, "max", 3, 2, 2),    # grouped + 3/2 pool (conv5)
]


def _conv_inputs(B, H, C, K, M, groups, seed=0):
    rng = np.random.default_rng(seed)
    return (_both(rng.standard_normal((B, H, H, C))),
            _both(rng.standard_normal((K, K, C // groups, M)) * 0.2),
            _both(rng.standard_normal(M)))


@pytest.mark.parametrize(
    "B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups", CONV_SHAPES)
def test_conv_bf16_matches_jax_oracle(B, H, C, K, M, stride, pad, pool,
                                      pool_k, pool_s, groups):
    """The wrapper (plain version: fp32, one rounding) and the port's
    oracle (bf16, two roundings) against JAX ``conv_pipe_ref`` in bf16."""
    (xj, xt), (wj, wt), (bj, bt) = _conv_inputs(B, H, C, K, M, groups)
    kw = dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups)
    want = jref.conv_pipe_ref(xj, wj, bj, **kw)
    n0 = conv_pipe.launches_bf16
    got = conv_pipe(xt, wt, bt, **kw)
    assert conv_pipe.launches_bf16 == n0       # a CPU tensor launches nothing
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    oracle = ref.conv_pipe_ref(xt, wt, bt, **kw)
    assert oracle.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(oracle), _np(want), **BF16)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_conv_bf16_plain_rounds_once(pool):
    """The plain version is the fp32 oracle on the widened operands,
    rounded once to bf16."""
    (_, xt), (_, wt), (_, bt) = _conv_inputs(2, 13, 3, 3, 8, 1, seed=3)
    kw = dict(pad=1, pool=pool, pool_k=3, pool_s=2)
    want = ref.conv_pipe_ref(xt.float(), wt.float(), bt.float(), **kw)
    assert torch.equal(conv_pipe_plain(xt, wt, bt, **kw),
                       want.to(torch.bfloat16))


@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (64, 128, 32, 32, 16, 64),
    (100, 300, 70, 32, 32, 64),       # non-divisible => padded
    (1, 256, 1000, 8, 128, 128),      # single-row FC
    (8, 9216, 128, 8, 64, 256),       # AlexNet fc6-like K at batch 8
])
@pytest.mark.parametrize("relu", [True, False])
def test_matmul_bf16_matches_jax_kernel(M, K, N, bm, bn, bk, relu):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.standard_normal((M, K)) * 0.3)
    wj, wt = _both(rng.standard_normal((K, N)) * 0.05)
    bj, bt = _both(rng.standard_normal(N))
    want = jax_matmul_pipe(xj, wj, bj, relu=relu, bm=bm, bn=bn, bk=bk,
                           interpret=True)
    got = matmul_pipe(xt, wt, bt, relu=relu)
    assert tuple(got.shape) == want.shape
    assert _ulps(got, want) <= 1.0
    oracle = ref.matmul_pipe_ref(xt, wt, bt, relu=relu)
    assert _ulps(oracle, jref.matmul_pipe_ref(xj, wj, bj, relu=relu)) <= 1.0


@pytest.mark.parametrize("shape", [(2, 6, 6, 8), (2, 6, 6, 96),
                                   (1, 5, 7, 3), (2, 13, 13, 48)])
def test_lrn_bf16_matches_jax_kernel(shape):
    xj, xt = _both(np.random.default_rng(2).standard_normal(shape) * 4)
    want = jax_lrn_pwl(xj, interpret=True)
    got = lrn_pwl(xt)
    assert tuple(got.shape) == want.shape
    assert _ulps(got, want) <= 1.0
    assert _ulps(ref.lrn_ref(xt), jref.lrn_ref(xj)) <= 1.0


@pytest.mark.parametrize("pool,k,s", [("max", 3, 2), ("max", 2, 2),
                                      ("avg", 3, 2), ("avg", 2, 2)])
def test_pool_bf16_matches_jax_oracle(pool, k, s):
    xj, xt = _both(np.random.default_rng(4).standard_normal((2, 13, 13, 8)))
    want = jref.pool_ref(xj, pool, k, s)
    got = ref.pool_ref(xt, pool, k, s)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    if pool == "max":                    # exact: a max picks one input
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


def _jax_bf16(arch):
    jcfg = jax_get_config(arch).smoke()
    return jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(
        precision=jpipe.Precision(dtype="bfloat16"), use_pallas=False))


@pytest.fixture(scope="module", params=CNN_IDS)
def jax_bf16(request):
    """(arch, the JAX bf16 compile, a bf16 batch of 2 as numpy fp32, the
    JAX logits on it)."""
    compiled = _jax_bf16(request.param)
    cfg = compiled.cfg
    x = np.random.default_rng(0).standard_normal(
        (2, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return request.param, compiled, np.asarray(xj, np.float32), \
        compiled.forward(xj)


def test_params_from_jax_keeps_bf16_bit_for_bit(jax_bf16):
    _, compiled, _, _ = jax_bf16
    params = params_from_jax(compiled.params, "cpu")
    for p, jp in zip(params, compiled.params, strict=True):
        assert (p is None) == (jp is None)
        if p is None:
            continue
        for k in ("w", "b"):
            assert jp[k].dtype == jnp.bfloat16 and p[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                p[k].view(torch.int16).numpy(),
                np.asarray(jp[k]).view(np.int16))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_forward_matches_jax(jax_bf16, use_kernels):
    """compile_cnn(Precision(dtype="bfloat16")).forward, with the kernels'
    plain versions (PWL LRN, one rounding) or the oracles, against the
    JAX oracle forward (use_pallas=False) on the same bf16 batch."""
    arch, jcompiled, x, want = jax_bf16
    compiled = compile_cnn(get_config(arch).smoke(), ExecutionSpec(
        precision=Precision(dtype="bfloat16"), use_kernels=use_kernels),
        params_from_jax(jcompiled.params, "cpu"), device="cpu")
    got = compiled.forward(x)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert bool(torch.isfinite(got).all())
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= LOGIT_RTOL * np.abs(want).max(), err


def test_bf16_forward_converts_its_batch_and_folds_by_stage():
    """forward takes a batch in any float dtype and converts it to bf16;
    the stage-by-stage fold equals it bit for bit."""
    cfg = get_config("alexnet").smoke()
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(dtype="bfloat16")),
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert {v.dtype for p in compiled.params if p is not None
            for v in p.values()} == {torch.bfloat16}
    x = np.random.default_rng(5).standard_normal(
        (2, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    want = compiled.forward(torch.from_numpy(x).to(torch.bfloat16))
    for given in (x, torch.from_numpy(x), torch.from_numpy(x).double()):
        assert torch.equal(compiled.forward(given), want)
    h = torch.from_numpy(x)
    for i in range(compiled.n_stages):
        h = compiled.forward_stage(i, h)
    assert h.dtype == torch.bfloat16 and torch.equal(h, want)


def test_compile_casts_fp32_params_to_bf16():
    """fp32 parameters handed to a bf16 compile are cast (exact for JAX
    bf16 parameters carried through params_from_jax); init_cnn_params
    draws in fp32 and casts, as the JAX package does."""
    cfg = get_config("vgg16").smoke()
    p32 = init_cnn_params(cfg, generator=torch.Generator().manual_seed(7),
                          device="cpu")
    p16 = init_cnn_params(cfg, generator=torch.Generator().manual_seed(7),
                          device="cpu", dtype=torch.bfloat16)
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(dtype="bfloat16")), p32, device="cpu")
    for a, b, c in zip(p32, p16, compiled.params, strict=True):
        if a is None:
            continue
        for k in ("w", "b"):
            assert b[k].dtype == c[k].dtype == torch.bfloat16
            assert torch.equal(a[k].to(torch.bfloat16), b[k])
            assert torch.equal(b[k], c[k])


@pytest.fixture(scope="module")
def served_bf16():
    cfg = get_config("vgg16").smoke()
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(dtype="bfloat16"), serving=Serving(batch=4)),
        generator=torch.Generator().manual_seed(0), device="cpu")
    reqs = synthetic_requests(7, cfg.input_hw, cfg.input_ch, 200.0)
    return reqs, compiled, compiled.serve(reqs)


def test_bf16_serve_completes_every_request_ok(served_bf16):
    reqs, _, rep = served_bf16
    assert sorted(c.rid for c in rep.completions) == list(range(len(reqs)))
    assert all(c.status == "ok" for c in rep.completions)
    assert rep.n_done == len(reqs) and rep.n_rejected == 0


def test_bf16_serve_preds_equal_the_forward(served_bf16):
    reqs, compiled, rep = served_bf16
    imgs = np.stack([r.image for r in reqs])
    preds = np.concatenate([
        compiled.forward(imgs[i:i + 4]).float().argmax(-1).numpy()
        for i in range(0, len(reqs), 4)])
    assert {c.rid: c.pred for c in rep.completions} == dict(
        enumerate(preds.tolist()))

