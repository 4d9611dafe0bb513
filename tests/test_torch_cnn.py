"""Whole-slice parity: the port's CNN forward against the JAX package's, on
the smoke configs (67x67 input, channels/16), with JAX-initialised
parameters carried across by ``params_from_jax`` and one numpy input fed
to both sides. Tolerance: fp32 ``rtol = atol = 1e-4``, as the
reference's own kernel tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.config import flops_per_image as jax_flops_per_image
from repro.kernels import ref as jref
from repro.kernels.lrn_pwl import lrn_pwl as jax_lrn_pwl
from repro.kernels.matmul_pipe import matmul_pipe as jax_matmul_pipe
from repro.models import cnn as jcnn
from repro_torch.configs import CNN_IDS, get_config
from repro_torch.core.config import flops_per_image
from repro_torch.models.cnn import (CNN, cnn_forward_stage, fuse_plan,
                                    init_cnn_params, params_from_jax)

FP32 = dict(rtol=1e-4, atol=1e-4)


def _setup(arch, batch=2, seed=0):
    jcfg = jax_get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    jparams = jcnn.init_cnn_params(jax.random.key(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (batch, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    return jcfg, cfg, jparams, x


def _jax_kernel_fold(params, x, cfg):
    """The JAX pipeline with the port's kernel semantics on every group:
    conv_pipe_ref for conv(+pool), the Pallas PWL LRN and matmul_pipe in
    interpret mode, pool_ref for standalone pools."""
    for group in jcnn.fuse_plan(cfg):
        l = cfg.layers[group[0]]
        p = params[group[0]]
        if l.kind == "conv":
            pool = cfg.layers[group[1]] if len(group) == 2 else None
            x = jref.conv_pipe_ref(
                x, p["w"], p["b"], stride=l.stride, pad=l.pad, relu=l.relu,
                pool=pool.pool if pool else None,
                pool_k=pool.kernel if pool else 2,
                pool_s=pool.stride if pool else 2, groups=l.groups)
        elif l.kind == "pool":
            x = jref.pool_ref(x, l.pool, l.kernel, l.stride)
        elif l.kind == "lrn":
            x = jax_lrn_pwl(x, interpret=True)
        else:
            x = jax_matmul_pipe(x.reshape(x.shape[0], -1), p["w"], p["b"],
                                relu=l.relu, interpret=True)
    return x


@pytest.mark.parametrize("arch", CNN_IDS)
def test_exact_forward_matches_jax(arch):
    """(a) use_kernels=False (the exact oracles) vs JAX use_pallas=False."""
    jcfg, cfg, jparams, x = _setup(arch)
    want = jcnn.cnn_forward_stage(jparams, jnp.asarray(x), jcfg,
                                  jcnn.fuse_plan(jcfg), use_pallas=False)
    got = CNN(cfg, params_from_jax(jparams, "cpu"), use_kernels=False)(
        torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_kernel_forward_matches_jax_kernel_fold():
    """(b) use_kernels=True on the CPU (the kernels' plain versions) vs the
    JAX fold over the same groups with the PWL LRN and matmul_pipe. Guards
    the NHWC flatten before fc6 and the grouped channel layout."""
    jcfg, cfg, jparams, x = _setup("alexnet")
    want = _jax_kernel_fold(jparams, jnp.asarray(x), jcfg)
    params = params_from_jax(jparams, "cpu")
    got = cnn_forward_stage(params, torch.from_numpy(x), cfg, fuse_plan(cfg),
                            use_kernels=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("arch", CNN_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_fuse_plan_and_flops_match_jax(arch, smoke):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if smoke:
        jcfg, cfg = jcfg.smoke(), cfg.smoke()
    assert (cfg.name, cfg.input_hw, cfg.input_ch, cfg.n_classes,
            cfg.use_lrn) == (jcfg.name, jcfg.input_hw, jcfg.input_ch,
                             jcfg.n_classes, jcfg.use_lrn)
    for l, jl in zip(cfg.layers, jcfg.layers, strict=True):
        assert dataclasses.asdict(l) == {
            f.name: getattr(jl, f.name) for f in dataclasses.fields(l)}
    assert fuse_plan(cfg) == jcnn.fuse_plan(jcfg)
    assert cfg.n_fuse_groups == jcfg.n_fuse_groups
    assert flops_per_image(cfg) == jax_flops_per_image(jcfg)


def test_params_from_jax_keeps_layout_and_values():
    jcfg, cfg, jparams, _ = _setup("alexnet")
    params = params_from_jax(jparams, "cpu")
    for p, jp in zip(params, jparams, strict=True):
        assert (p is None) == (jp is None)
        if p is not None:
            for k in ("w", "b"):
                assert p[k].dtype == torch.float32
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("arch", CNN_IDS)
def test_init_cnn_params_shapes_and_scaling_match_jax(arch):
    jcfg, cfg, jparams, _ = _setup(arch)
    params = init_cnn_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    for l, p, jp in zip(cfg.layers, params, jparams, strict=True):
        assert (p is None) == (jp is None)
        if p is None:
            continue
        assert tuple(p["w"].shape) == jp["w"].shape
        assert not p["b"].any()
        fan_in = int(np.prod(p["w"].shape[:-1]))
        std = np.sqrt(2.0 / fan_in) if l.kind == "conv" else 1 / np.sqrt(fan_in)
        if p["w"].numel() >= 1000:           # enough draws for a 10% check
            assert abs(p["w"].std().item() / std - 1) < 0.1
