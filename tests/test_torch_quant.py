"""The port's int8 pipeline against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both sides; JAX
parameters and JAX-calibrated ``QuantizedCNNParams`` are carried across
through numpy. Tolerances:

* exact equality for the quantization primitives, the observers, the
  exact-int oracles (``conv_int8_ref`` against JAX's; ``fc_int8_ref``
  against the Pallas ``matmul_pipe`` int8 mode in interpret mode -- the
  Pallas ``conv_pipe`` cannot run under this jax, no ``pl.Unblocked``),
  the weight codes of a calibration, and every int8 group without LRN;
* calibration's activation scales within rtol 1e-5 (the fp32 forward
  sums in another order);
* LRN groups within one code: the port's LRN is held at rtol 1e-6 to
  JAX's, not bit for bit, so a requantize may round the other way;
* whole AlexNet forwards: top-1 equal and logits within
  1e-3 * max|logit| (the LRN codes above, through three fc layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jref
from repro.kernels.lrn_pwl import lrn_pwl as jax_lrn_pwl
from repro.kernels.matmul_pipe import matmul_pipe as jax_matmul_pipe
from repro.models import cnn as jcnn
from repro.quant import calibrate as jcal
from repro.quant import core as jcore
from repro.quant import observers as jobs
from repro.quant import ref as jqref
from repro_torch.configs import get_config
from repro_torch.core.config import SpecError
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.codes import (max_pool_codes, max_pool_codes_plain,
                                       quantize_codes, quantize_codes_plain)
from repro_torch.kernels.conv_pipe import conv_pipe
from repro_torch.kernels.lrn_pwl import (lrn_pwl, lrn_pwl_plain,
                                          lrn_pwl_s8_plain)
from repro_torch.kernels.matmul_pipe import matmul_pipe
from repro_torch.models import cnn
from repro_torch.models.cnn import params_from_jax
from repro_torch.pipeline import (ExecutionSpec, Precision, Serving,
                                  compile_cnn)
from repro_torch.quant import (AbsMaxObserver, MovingAverageAbsMaxObserver,
                               QuantizedCNNParams, abs_max_scale,
                               calibrate_cnn, dequantize, fake_quant,
                               make_observer, qparams_from_jax, quantize,
                               quantize_channelwise)
from repro_torch.quant import ref as qref

LOGIT_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _with_ties(rng, s, n=20_000):
    ties = (rng.integers(-140, 140, n) + 0.5) * np.float32(s)
    return np.concatenate([ties, rng.standard_normal(n) * 3]).astype(
        np.float32)


# -- primitives ---------------------------------------------------------------

@pytest.mark.parametrize("s", [0.0371, 0.1, 1.0 / 127, 2.5])
def test_quantize_and_dequantize_match_jax_at_ties(s):
    x = _with_ties(np.random.default_rng(0), s)
    q = quantize(_t(x), s)
    _eq(q.numpy(), jcore.quantize(jnp.asarray(x), s))
    _eq(dequantize(q, s).numpy(),
        jcore.dequantize(jnp.asarray(q.numpy()), s))
    _eq(fake_quant(_t(x), s).numpy(), jcore.fake_quant(jnp.asarray(x), s))


def test_per_channel_quantize_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 5, 6)).astype(np.float32) * 3
    s = (rng.random(6) * 0.05 + 0.01).astype(np.float32)
    _eq(quantize(_t(x), _t(s)).numpy(),
        jcore.quantize(jnp.asarray(x), jnp.asarray(s)))


@pytest.mark.parametrize("axis,keepdims", [(None, False), ((0, 1, 2), True),
                                           ((0, 1, 2), False), (0, False)])
def test_abs_max_scale_matches_jax(axis, keepdims):
    w = np.random.default_rng(2).standard_normal((3, 3, 4, 8)).astype(
        np.float32)
    w[..., 0] = 0.0                         # an all-zero channel: _EPS
    _eq(abs_max_scale(_t(w), axis=axis, keepdims=keepdims).numpy(),
        jcore.abs_max_scale(jnp.asarray(w), axis=axis, keepdims=keepdims))


@pytest.mark.parametrize("shape", [(3, 3, 4, 16), (11, 11, 3, 8),
                                   (300, 70)])
def test_quantize_channelwise_matches_jax(shape):
    w = (np.random.default_rng(3).standard_normal(shape) * 0.2).astype(
        np.float32)
    q, s = quantize_channelwise(_t(w))
    jq, js = jcore.quantize_channelwise(jnp.asarray(w))
    _eq(q.numpy(), jq)
    _eq(s.numpy(), js)


@pytest.mark.parametrize("kind", ["absmax", "ema"])
def test_observers_match_jax(kind):
    rng = np.random.default_rng(4)
    ours, theirs = make_observer(kind), jobs.make_observer(kind)
    assert type(ours) is {"absmax": AbsMaxObserver,
                          "ema": MovingAverageAbsMaxObserver}[kind]
    for i in range(4):
        x = (rng.standard_normal((2, 5, 5, 3)) * (1 + i)).astype(np.float32)
        ours.update(_t(x))
        theirs.update(jnp.asarray(x))
        assert ours.amax == theirs.amax
        assert ours.scale() == theirs.scale()
    with pytest.raises(ValueError):
        make_observer("minmax")
    with pytest.raises(ValueError):
        AbsMaxObserver().scale()


# -- the exact-int oracles (the plain versions of the int8 kernel modes) ------

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


def _int8_operands(rng, x_shape, w_shape, k):
    x = rng.integers(-127, 128, x_shape, dtype=np.int8)
    w = rng.integers(-127, 128, w_shape, dtype=np.int8)
    n = w_shape[-1]
    scale = ((0.5 + rng.random(n)) / (127.0 ** 2 / 3 * np.sqrt(k))).astype(
        np.float32)
    b = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return x, w, b, scale


@pytest.mark.parametrize("out_scale", [3.0 / 127, None], ids=["s8", "f32"])
@pytest.mark.parametrize(
    "B,H,C,K,M,stride,pad,pool,pool_k,pool_s,groups", CONV_GEOMETRIES)
def test_conv_int8_ref_equals_jax(B, H, C, K, M, stride, pad, pool, pool_k,
                                  pool_s, groups, out_scale):
    rng = np.random.default_rng(5)
    x, w, b, scale = _int8_operands(rng, (B, H, H, C),
                                    (K, K, C // groups, M),
                                    K * K * C // groups)
    kw = dict(stride=stride, pad=pad, pool=pool, pool_k=pool_k,
              pool_s=pool_s, groups=groups, out_scale=out_scale)
    want = jqref.conv_int8_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               jnp.asarray(scale), **kw)
    got = qref.conv_int8_ref(_t(x), _t(w), _t(b), _t(scale), **kw)
    assert got.is_contiguous()               # NHWC, as the kernel writes it
    _eq(got.numpy(), want)
    n0 = (conv_pipe.launches, conv_pipe.launches_s8)
    _eq(conv_pipe(_t(x), _t(w), _t(b), scale=_t(scale), **kw).numpy(), want)
    assert (conv_pipe.launches, conv_pipe.launches_s8) == n0


@pytest.mark.parametrize("out_scale", [3.0 / 127, None], ids=["s8", "f32"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M,K,N", [(8, 300, 70), (3, 256, 130),
                                   (8, 1024, 64)])
def test_fc_int8_ref_equals_jax_pallas_kernel(M, K, N, relu, out_scale):
    """Bit-equal to the JAX oracle, and to the Pallas kernel where it
    emits int8. With fp32 output the interpret-mode kernel is one ulp off
    in places of the largest output: XLA on the CPU contracts its
    ``acc * scale + b`` into one FMA, where the oracle (and the port, and
    its CUDA kernel) round twice."""
    rng = np.random.default_rng(6)
    x, w, b, scale = _int8_operands(rng, (M, K), (K, N), K)
    kernel = np.asarray(jax_matmul_pipe(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        scale=jnp.asarray(scale), out_scale=out_scale, relu=relu,
        interpret=True))
    want = jqref.fc_int8_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             jnp.asarray(scale), relu=relu,
                             out_scale=out_scale)
    got = qref.fc_int8_ref(_t(x), _t(w), _t(b), _t(scale), relu=relu,
                           out_scale=out_scale).numpy()
    _eq(got, want)
    if out_scale is not None:
        _eq(got, kernel)
    else:
        np.testing.assert_allclose(
            got, kernel, rtol=0, atol=np.spacing(np.abs(kernel).max()))
    n0 = (matmul_pipe.launches, matmul_pipe.launches_s8)
    _eq(matmul_pipe(_t(x), _t(w), _t(b), relu=relu, scale=_t(scale),
                    out_scale=out_scale).numpy(), want)
    assert (matmul_pipe.launches, matmul_pipe.launches_s8) == n0


@pytest.mark.parametrize("pool", [None, "max", "avg"])
def test_conv_fake_quant_ref_matches_jax(pool):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 13, 13, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 4, 12)) * 0.2).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    w_scale = np.abs(w).max(axis=(0, 1, 2)).astype(np.float32) / 127
    kw = dict(x_scale=0.03, pad=1, pool=pool, pool_k=3, pool_s=2, groups=2)
    want = jqref.conv_fake_quant_ref(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b),
                                     w_scale=jnp.asarray(w_scale), **kw)
    got = qref.conv_fake_quant_ref(_t(x), _t(w), _t(b), w_scale=_t(w_scale),
                                   **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- calibration ----------------------------------------------------------------

def _setup(arch, batch=2, seed=0):
    jcfg = jax_get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    jparams = jcnn.init_cnn_params(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(
        (batch, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    calib = np.random.default_rng(123).standard_normal(
        (4, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    return jcfg, cfg, jparams, x, calib


@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_calibration_matches_jax(arch):
    jcfg, cfg, jparams, _, calib = _setup(arch)
    want = jcal.calibrate_cnn(jparams, jnp.asarray(calib), jcfg)
    got = calibrate_cnn(params_from_jax(jparams, "cpu"), calib, cfg)
    assert isinstance(got, QuantizedCNNParams)
    assert got.in_scale == want.in_scale
    for g, w in zip(got.layers, want.layers, strict=True):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.kind == w.kind
        for name in ("x_scale", "y_scale"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None)
            if b is not None:
                assert a == pytest.approx(b, rel=1e-5)
        if w.w_q is not None:
            _eq(g.w_q.numpy(), w.w_q)
            _eq(g.w_scale.numpy(), w.w_scale)
            _eq(g.b.numpy(), w.b)
            np.testing.assert_allclose(g.scale.numpy(), np.asarray(w.scale),
                                       rtol=1e-5)


def test_calibration_takes_a_stream_and_is_deterministic():
    _, cfg, jparams, _, calib = _setup("alexnet")
    params = params_from_jax(jparams, "cpu")
    one = calibrate_cnn(params, [calib[:2], calib[2:]], cfg, observer="ema")
    two = calibrate_cnn(params, iter([calib[:2], calib[2:]]), cfg,
                        observer="ema")
    assert [None if l is None else (l.x_scale, l.y_scale)
            for l in one.layers] == [None if l is None else (l.x_scale,
                                                             l.y_scale)
                                     for l in two.layers]
    with pytest.raises(ValueError):
        calibrate_cnn(params, [], cfg)


def test_qparams_from_jax_keeps_codes_and_scales():
    jcfg, _, jparams, _, calib = _setup("alexnet")
    jqp = jcal.calibrate_cnn(jparams, jnp.asarray(calib), jcfg)
    qp = qparams_from_jax(jqp, "cpu")
    assert qp.in_scale == jqp.in_scale
    for g, w in zip(qp.layers, jqp.layers, strict=True):
        if w is None:
            assert g is None
            continue
        assert (g.kind, g.x_scale, g.y_scale) == (w.kind, w.x_scale,
                                                  w.y_scale)
        for k in ("w_q", "w_scale", "scale", "b"):
            if getattr(w, k) is None:
                assert getattr(g, k) is None
            else:
                _eq(getattr(g, k).numpy(), getattr(w, k))


# -- the int8 forward -------------------------------------------------------------

def _jax_qp(arch):
    jcfg, cfg, jparams, x, calib = _setup(arch)
    jqp = jcal.calibrate_cnn(jparams, jnp.asarray(calib), jcfg)
    return jcfg, cfg, jqp, qparams_from_jax(jqp, "cpu"), x


def _logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert (got.argmax(-1) == want.argmax(-1)).all()
    tol = LOGIT_RTOL * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("use_kernels", [False, True])
def test_vgg16_int8_logits_bit_equal_to_jax(use_kernels):
    jcfg, cfg, jqp, qp, x = _jax_qp("vgg16")
    want = jcnn.cnn_forward_quant(jqp, jnp.asarray(x), jcfg,
                                  use_pallas=False)
    _eq(cnn.cnn_forward_quant(qp, _t(x), cfg,
                              use_kernels=use_kernels).numpy(), want)


def _jax_kernel_group(jqp, q, cfg, group):
    """One int8 group with the port's kernel semantics in JAX: the exact
    conv oracle, the Pallas PWL LRN and int8 matmul_pipe in interpret
    mode, pool_ref on the codes."""
    l, ql = cfg.layers[group[0]], jqp.layers[group[0]]
    if l.kind == "lrn":
        return jcore.quantize(jax_lrn_pwl(jcore.dequantize(q, ql.x_scale),
                                          interpret=True), ql.y_scale)
    if l.kind == "fc":
        return jax_matmul_pipe(q.reshape(q.shape[0], -1), ql.w_q, ql.b,
                               scale=ql.scale, out_scale=ql.y_scale,
                               relu=l.relu, interpret=True)
    return jcnn.run_group_quant(jqp, q, cfg, group, use_pallas=False)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["oracles", "kernels"])
def test_alexnet_int8_groups_match_jax(use_kernels):
    """Each group fed JAX's int8 input: conv, pool and fc groups bit-equal,
    LRN groups within one code; then the whole forward."""
    jcfg, cfg, jqp, qp, x = _jax_qp("alexnet")
    q = jcore.quantize(jnp.asarray(x), jqp.in_scale)
    _eq(ops.quantize_q(_t(x), qp.in_scale,
                       use_kernels=use_kernels).numpy(), q)
    for group in jcnn.fuse_plan(jcfg):
        want = (_jax_kernel_group(jqp, q, jcfg, group) if use_kernels else
                jcnn.run_group_quant(jqp, q, jcfg, group, use_pallas=False))
        got = cnn.run_group_quant(qp, _t(q), cfg, group,
                                  use_kernels=use_kernels).numpy()
        if cfg.layers[group[0]].kind == "lrn":
            assert got.dtype == np.int8
            diff = np.abs(got.astype(np.int32) - np.asarray(want, np.int32))
            assert diff.max() <= 1
        else:
            _eq(got, want)
        q = want
    logits = cnn.cnn_forward_quant(qp, _t(x), cfg, use_kernels=use_kernels)
    want = q if use_kernels else jcnn.cnn_forward_quant(
        jqp, jnp.asarray(x), jcfg, use_pallas=False)
    _logits_close(logits.numpy(), want)


def test_quant_groups_yield_codes_and_scales_like_jax():
    jcfg, cfg, jqp, qp, x = _jax_qp("vgg16")
    got = list(cnn._quant_groups(qp, _t(x), cfg, use_kernels=False))
    want = list(jcnn._quant_groups(jqp, jnp.asarray(x), jcfg,
                                   use_pallas=False))
    assert [(g, s) for g, _, s in got] == [(g, s) for g, _, s in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        _eq(a.numpy(), b)


def test_quant_module_stages_and_buffers():
    _, cfg, _, qp, x = _jax_qp("alexnet")
    m = cnn.QuantCNN(cfg, qp, use_kernels=True)
    assert not list(m.parameters()) and len(list(m.buffers())) == 8 * 4
    h = _t(x)
    for g in m.groups:
        h = m.forward_groups(h, [g])
    _eq(h.numpy(), m(_t(x)).numpy())
    back = m.qparams
    assert back.in_scale == qp.in_scale
    for a, b in zip(back.layers, qp.layers, strict=True):
        assert (a is None) == (b is None)
        if b is not None and b.w_q is not None:
            assert a.w_q is b.w_q and a.y_scale == b.y_scale
    with pytest.raises(ValueError):
        cnn.QuantCNN(cfg, QuantizedCNNParams(qp.layers[:-1]))


# -- the int8 glue: lrn_pwl's int8 mode, the edge quantize, the pool on codes --

def _glue_launches():
    return (lrn_pwl.launches, lrn_pwl.launches_s8, quantize_codes.launches,
            max_pool_codes.launches)


def _codes_with_ends(rng, shape):
    """Random int8 codes with +127 and -127 in every pixel."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    q[..., 0], q[..., -1] = 127, -127
    return torch.from_numpy(q)


@pytest.mark.parametrize("steps", [(0.0371, 0.05), (1.0 / 127, 2.0 / 127),
                                   (0.5, 0.25)])
@pytest.mark.parametrize("shape", [(1, 13, 13, 96), (1, 6, 6, 256),
                                   (2, 5, 7, 12), (1, 4, 4, 3)])
def test_lrn_pwl_s8_plain_is_the_chain(shape, steps):
    """The int8 mode on a CPU tensor is its plain version, which is the
    chain the int8 fold ran before: quantize(lrn_pwl(dequantize(q)))."""
    xs, ys = steps
    q = _codes_with_ends(np.random.default_rng(31), shape)
    want = quantize(lrn_pwl_plain(dequantize(q, xs)), ys)
    n0 = _glue_launches()
    _eq(lrn_pwl(q, x_scale=xs, y_scale=ys).numpy(), want.numpy())
    _eq(lrn_pwl_s8_plain(q, xs, ys).numpy(), want.numpy())
    assert _glue_launches() == n0             # a CPU tensor launches nothing


@pytest.mark.parametrize("s", [0.0371, 1.0 / 127, 2.5])
def test_quantize_codes_plain_is_quantize(s):
    rng = np.random.default_rng(32)
    x = np.concatenate([_with_ties(rng, s), rng.standard_normal(64) * 200 * s,
                        [np.inf, -np.inf]]).astype(np.float32)
    n0 = _glue_launches()
    want = quantize(_t(x), s).numpy()
    _eq(quantize_codes(_t(x), s).numpy(), want)
    _eq(quantize_codes_plain(_t(x), s).numpy(), want)
    assert _glue_launches() == n0


@pytest.mark.parametrize("k,s", [(3, 2), (2, 2)])
@pytest.mark.parametrize("shape", [(2, 13, 13, 96), (1, 7, 9, 3)])
def test_max_pool_codes_plain_is_pool_ref(shape, k, s):
    q = torch.from_numpy(np.random.default_rng(33).integers(
        -128, 128, shape).astype(np.int8))
    n0 = _glue_launches()
    want = kref.pool_ref(q, "max", k, s).numpy()
    _eq(max_pool_codes(q, k, s).numpy(), want)
    _eq(max_pool_codes_plain(q, k, s).numpy(), want)
    assert _glue_launches() == n0


def test_glue_wrappers_refuse_what_they_do_not_take():
    q = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    for bad in (dict(), dict(x_scale=0.1), dict(y_scale=0.1),
                dict(x_scale=0.1, y_scale=0.0),
                dict(x_scale=0.1, y_scale=float("nan")),
                dict(x_scale=torch.tensor(0.1), y_scale=0.1)):
        with pytest.raises(ValueError):
            lrn_pwl(q, **bad)
    with pytest.raises(ValueError):
        lrn_pwl(q.float(), x_scale=0.1, y_scale=0.1)     # steps on floats
    meta = torch.zeros((1, 4, 4, 16), device="meta")
    with pytest.raises(ValueError):
        quantize_codes(meta, 0.1)
    with pytest.raises(ValueError):
        max_pool_codes(meta.to(torch.int8), 2, 2)


def _parent_fold(qp, x, cfg, groups):
    """The int8 fold as it ran before its glue had kernels: quantize at
    the edge, pool_ref on the codes, and dequantize -> the fp32 LRN ->
    quantize around each LRN; every other group as the fold runs it."""
    q = quantize(x, qp.in_scale)
    for group in groups:
        l, ql = cfg.layers[group[0]], qp.layers[group[0]]
        if l.kind == "pool":
            q = kref.pool_ref(q, l.pool, l.kernel, l.stride)
        elif l.kind == "lrn":
            q = quantize(lrn_pwl(dequantize(q, ql.x_scale)), ql.y_scale)
        else:
            q = cnn.run_group_quant(qp, q, cfg, group)
    return q


@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_int8_fold_with_kernels_on_the_cpu_is_the_parents_path(arch):
    """use_kernels=True on CPU tensors runs the glue's plain versions: the
    logits equal the fold's before the glue had kernels, bit for bit, and
    nothing launches."""
    _, cfg, _, qp, x = _jax_qp(arch)
    m = cnn.QuantCNN(cfg, qp, use_kernels=True)
    want = _parent_fold(qp, _t(x), cfg, m.groups)
    n0 = _glue_launches()
    _eq(m(_t(x)).numpy(), want.numpy())
    _eq(cnn.cnn_forward_quant(qp, _t(x), cfg).numpy(), want.numpy())
    assert _glue_launches() == n0


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["oracles", "kernels"])
def test_int8_lrn_dispatch(monkeypatch, use_kernels):
    """use_kernels=False runs the exact LRN (lrn_ref) between a dequantize
    and a quantize; True runs lrn_pwl's int8 mode on the codes."""
    _, cfg, _, qp, x = _jax_qp("alexnet")
    seen = []

    def spy(name, fn):
        def call(x, *a, **kw):
            seen.append((name, x.dtype))
            return fn(x, *a, **kw)
        return call
    monkeypatch.setattr(kref, "lrn_ref", spy("lrn_ref", kref.lrn_ref))
    monkeypatch.setattr(ops, "lrn_pwl", spy("lrn_pwl", ops.lrn_pwl))
    cnn.QuantCNN(cfg, qp, use_kernels=use_kernels)(_t(x))
    assert seen == ([("lrn_pwl", torch.int8)] * 2 if use_kernels else
                    [("lrn_ref", torch.float32)] * 2)


# -- compile_cnn(Precision(quant="int8")) ------------------------------------------

@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_compile_int8_default_calibration_matches_jax(arch):
    jcfg, cfg, jparams, x, _ = _setup(arch)
    jc = jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(
        precision=jpipe.Precision(quant="int8", calib=4),
        serving=jpipe.Serving(batch=2), use_pallas=False), jparams)
    c = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(quant="int8", calib=4),
        serving=Serving(batch=2), use_kernels=False),
        params_from_jax(jparams, "cpu"), device="cpu")
    assert c.quant and jc.quant
    assert c.params.in_scale == jc.params.in_scale
    _logits_close(c.forward(x).numpy(), jc.forward(jnp.asarray(x)))


def test_compile_takes_every_precision_source():
    jcfg, cfg, jparams, x, calib = _setup("alexnet")
    params = params_from_jax(jparams, "cpu")
    spec = ExecutionSpec(precision=Precision(quant="int8"))
    by_pair = compile_cnn(cfg, spec, (params, calib), device="cpu")
    qp = calibrate_cnn(params, calib, cfg)
    by_qp = compile_cnn(cfg, spec, qp, device="cpu")
    _eq(by_pair.forward(x).numpy(), by_qp.forward(x).numpy())
    # a bare batch calibrates fresh parameters
    bare = compile_cnn(cfg, spec, calib, device="cpu")
    assert bare.quant and bare.params.in_scale == qp.in_scale
    # stage fold: int8 codes cross every interior boundary
    h = torch.from_numpy(x)
    for i in range(by_qp.n_stages):
        h = by_qp.forward_stage(i, h)
        assert h.dtype == (torch.int8 if i < by_qp.n_stages - 1
                           else torch.float32)
    _eq(h.numpy(), by_qp.forward(x).numpy())
    assert "quant=int8" in repr(by_qp)


def _spec_error(make):
    with pytest.raises(ValueError) as e:
        make()
    return type(e.value).__name__, getattr(e.value, "field", None), \
        str(e.value)


@pytest.mark.parametrize("case", ["calib0", "bf16", "batch_without_int8",
                                  "qparams_without_int8"])
def test_precision_errors_are_the_jax_ones(case):
    jcfg, cfg, jparams, _, calib = _setup("alexnet")
    params = params_from_jax(jparams, "cpu")
    qp = calibrate_cnn(params, calib, cfg)
    jqp = jcal.calibrate_cnn(jparams, jnp.asarray(calib), jcfg)
    make = {
        "calib0": (lambda: ExecutionSpec(precision=Precision(
            quant="int8", calib=0)), lambda: jpipe.ExecutionSpec(
            precision=jpipe.Precision(quant="int8", calib=0))),
        "bf16": (lambda: ExecutionSpec(precision=Precision(
            quant="int8", dtype="bfloat16")), lambda: jpipe.ExecutionSpec(
            precision=jpipe.Precision(quant="int8", dtype="bfloat16"))),
        "batch_without_int8": (
            lambda: compile_cnn(cfg, ExecutionSpec(), (params, calib),
                                device="cpu"),
            lambda: jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(),
                                      (jparams, jnp.asarray(calib)))),
        "qparams_without_int8": (
            lambda: compile_cnn(cfg, ExecutionSpec(), qp, device="cpu"),
            lambda: jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(), jqp)),
    }[case]
    got, want = _spec_error(make[0]), _spec_error(make[1])
    assert got[1:] == want[1:]
    assert (got[0] == "SpecError") == (want[0] == "SpecError")
    if case in ("calib0", "bf16"):
        assert isinstance(pytest.raises(SpecError, make[0]).value, SpecError)
