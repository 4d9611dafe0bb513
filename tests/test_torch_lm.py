"""The port's LM side (slice 8a) against the JAX package, on the CPU.

Configs, the MoE routing and dispatch, the Mamba2 / mLSTM / sLSTM blocks
and the unified LM (``forward``, ``prefill`` and ``decode_step`` for every
``ARCH_ID`` on ``smoke()``). Inputs are made with numpy from a seed and
fed to both sides; JAX's ``init_params`` is carried across with
``lm.params_from_jax``. Tolerances: 1e-4 (rtol and atol) in fp32; in bf16
``2e-2 x max|logit|``, the reference's bf16 tolerance on the logits'
scale; routing indices, capacities and queue positions equal as integers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import config as jconfig
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro_torch.configs import all_lm_configs, get_config
from repro_torch.core import config as tconfig
from repro_torch.models import lm, mlp, ssm

F32 = dict(rtol=1e-4, atol=1e-4)


def _jit(fn):
    """JAX's ``fn(p, x, cfg, ...)`` jitted, cfg static: one compile a
    shape, not one a primitive."""
    return jax.jit(fn, static_argnums=2)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _to_torch(tree):
    return lm.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _leaves(cache):
    """A DecodeCache's leaves in field order (both packages)."""
    return jax.tree.leaves(cache, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def _close_logits(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        w = _np(want)
        err = np.abs(_np(got) - w).max()
        assert err <= 2e-2 * np.abs(w).max(), (err, np.abs(w).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_smoke_equal_jax_field_for_field(arch):
    want, got = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.smoke()) == dataclasses.asdict(want.smoke())
    for prop in ("is_moe", "is_ssm", "ssm_d_inner", "ssm_heads"):
        assert getattr(got, prop) == getattr(want, prop)
    assert got.supports_long_context() == want.supports_long_context()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_jax_at_full_size(arch):
    want, got = jax_get_config(arch), get_config(arch)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_registry_resolves_every_id_and_alias():
    from repro.configs import _ALIASES
    assert list(all_lm_configs()) == ARCH_IDS
    for alias, arch in _ALIASES.items():
        assert get_config(alias) is get_config(arch)
    assert get_config("zamba2-1.2b").name == "zamba2-1.2b"
    assert get_config("qwen3.8b".replace(".", "_")) is get_config("qwen3_8b")
    with pytest.raises(KeyError):
        get_config("gpt-5")


def test_shapes_equal_jax():
    assert ([dataclasses.asdict(s) for s in tconfig.SHAPES]
            == [dataclasses.asdict(s) for s in jconfig.SHAPES])
    for s in jconfig.SHAPES:
        assert tconfig.get_shape(s.name).tokens == s.tokens
    with pytest.raises(KeyError):
        tconfig.get_shape("train_8k")
    for arch in ARCH_IDS:
        assert ([s.name for s in tconfig.applicable_shapes(get_config(arch))]
                == [s.name for s in jconfig.applicable_shapes(
                    jax_get_config(arch))])


# ---------------------------------------------------------------------------
# MoE: routing, capacity, dispatch, forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_topk_matches_jax(k):
    logits = np.random.default_rng(k).standard_normal((37, 8)).astype(
        np.float32)
    w_j, i_j = jmlp.route_topk(jnp.asarray(logits), k)
    w_t, i_t = mlp.route_topk(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6,
                               atol=1e-7)


def test_route_topk_ties_take_the_lower_expert_first():
    """A router of zeros (all gates equal) picks experts 0..k-1, as
    ``jax.lax.top_k`` does; so do ties inside a row."""
    zeros = np.zeros((5, 16), np.float32)
    _, i_j = jmlp.route_topk(jnp.asarray(zeros), 4)
    _, i_t = mlp.route_topk(torch.from_numpy(zeros), 4)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert (i_t.numpy() == np.arange(4)).all()
    tied = np.array([[0.0, 2.0, 1.0, 2.0, 2.0, 1.0]], np.float32)
    _, i_j = jmlp.route_topk(jnp.asarray(tied), 4)
    _, i_t = mlp.route_topk(torch.from_numpy(tied), 4)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


@pytest.mark.parametrize("arch", ["dbrx_132b", "arctic_480b"])
def test_expert_capacity_equals_jax(arch):
    jc, tc = jax_get_config(arch), get_config(arch)
    for n in (1, 7, 8, 40, 64, 100, 1000, 4096, 4608, 131072):
        for f in (1.0, 1.25, 2.0):
            assert mlp.expert_capacity(n, tc, f) == jmlp.expert_capacity(
                n, jc, f)


@pytest.mark.parametrize("T,K,E", [(5, 2, 4), (700, 2, 4), (600, 4, 16),
                                   (3000, 1, 8)])
def test_dispatch_indices_equal_jax(T, K, E):
    """JAX's two-level blocked count (blocks of 1024 choices) and the
    port's plain exclusive cumsum give the same integers."""
    idx = np.random.default_rng(T).integers(0, E, (T, K))
    e_j, p_j = jmlp.moe_dispatch_indices(jnp.asarray(idx, jnp.int32), E)
    e_t, p_t = mlp.moe_dispatch_indices(torch.from_numpy(idx), E)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


def _moe(arch, seed=0, dtype="float32"):
    jc = dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype)
    tc = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    from repro.models.layers import dtype_of
    p_j = jmlp.init_moe_params(jax.random.key(seed), jc, dtype_of(dtype))
    return jc, tc, p_j


@pytest.mark.parametrize("arch", ["dbrx_132b", "arctic_480b"],
                         ids=["moe", "moe_dense_residual"])
@pytest.mark.parametrize("B,S", [(2, 12), (1, 1), (3, 40)])
def test_moe_forward_matches_jax(arch, B, S):
    jc, tc, p_j = _moe(arch)
    assert tc.moe_dense_residual == (arch == "arctic_480b")
    x = np.random.default_rng(S).standard_normal((B, S, jc.d_model)).astype(
        np.float32)
    y_j, aux_j = _jit(jmlp.moe_forward)(p_j, jnp.asarray(x), jc)
    y_t, aux_t = mlp.moe_forward(_to_torch(p_j), torch.from_numpy(x), tc)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5)


@pytest.mark.parametrize("groups", [2, 5])
def test_moe_dispatch_groups_match_jax(groups):
    """Capacity per group of tokens (``moe_groups``): 24 tokens in 2
    groups of 12, and 5 groups, which do not divide 24, fall back to 1."""
    jc, tc, p_j = _moe("dbrx_132b")
    jc = dataclasses.replace(jc, moe_groups=groups)
    tc = dataclasses.replace(tc, moe_groups=groups)
    x = _x((2, 12, jc.d_model), groups)
    y_j, aux_j = _jit(jmlp.moe_forward)(p_j, jnp.asarray(x), jc)
    y_t, aux_t = mlp.moe_forward(_to_torch(p_j), torch.from_numpy(x), tc)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5)


@pytest.mark.parametrize("arch", ["dbrx_132b", "arctic_480b"],
                         ids=["moe", "moe_dense_residual"])
def test_overflowing_router_drops_as_jax(arch):
    """A router that sends every token to expert 0: 48 tokens x 2 choices
    against a capacity of 32 a expert. The other gates tie, so every
    second choice is expert 1; experts 0 and 1 each drop their last 16
    tokens."""
    jc, tc, p_j = _moe(arch)
    router = np.zeros((jc.d_model, jc.n_experts), np.float32)
    router[:, 0] = 1.0
    p_j = dict(p_j, router=jnp.asarray(router))
    x = np.abs(np.random.default_rng(3).standard_normal(
        (2, 24, jc.d_model))).astype(np.float32)
    logits = x.reshape(-1, jc.d_model) @ router
    _, idx = mlp.route_topk(torch.from_numpy(logits), jc.top_k)
    assert (idx[:, 0] == 0).all() and (idx[:, 1] == 1).all()
    C = mlp.expert_capacity(48, tc)
    _, pos = mlp.moe_dispatch_indices(idx, jc.n_experts)
    assert C == 32 and int((pos >= C).sum()) == 32
    y_j, _ = _jit(jmlp.moe_forward)(p_j, jnp.asarray(x), jc)
    y_t, _ = mlp.moe_forward(_to_torch(p_j), torch.from_numpy(x), tc)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)


def test_moe_forward_bf16_matches_jax():
    jc, tc, p_j = _moe("dbrx_132b", dtype="bfloat16")
    x = np.random.default_rng(4).standard_normal((2, 12, jc.d_model))
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    y_j, _ = _jit(jmlp.moe_forward)(p_j, xj, jc)
    y_t, _ = mlp.moe_forward(_to_torch(p_j), xt, tc)
    assert y_t.dtype == torch.bfloat16
    _close_logits(y_t, y_j, "bfloat16")


# ---------------------------------------------------------------------------
# SSM blocks
# ---------------------------------------------------------------------------

def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _state_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("S", [16, 20, 5])     # chunks; a remainder; < Q
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_forward_matches_jax(S, with_state):
    cfg_j = jax_get_config("zamba2_1p2b").smoke()
    cfg_t = get_config("zamba2_1p2b").smoke()
    p_j = jssm.init_mamba_params(jax.random.key(1), cfg_j, jnp.float32)
    p_t = _to_torch(p_j)
    x = _x((2, S, cfg_j.d_model), S)
    st_j = st_t = None
    if with_state:
        d_inner, nh, P, N = jssm.mamba_dims(cfg_j)
        a = _x((2, nh, P, N), 1) * 0.1
        c = _x((2, cfg_j.ssm_conv_width - 1, d_inner + 2 * N), 2) * 0.1
        st_j = jssm.MambaState(jnp.asarray(a), jnp.asarray(c))
        st_t = ssm.MambaState(torch.from_numpy(a), torch.from_numpy(c))
    y_j, s_j = _jit(jssm.mamba_forward)(p_j, jnp.asarray(x), cfg_j, st_j)
    y_t, s_t = ssm.mamba_forward(p_t, torch.from_numpy(x), cfg_t, st_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    _state_close(s_t, s_j)


def test_mamba_decode_matches_jax():
    cfg_j = jax_get_config("zamba2_1p2b").smoke()
    cfg_t = get_config("zamba2_1p2b").smoke()
    p_j = jssm.init_mamba_params(jax.random.key(2), cfg_j, jnp.float32)
    p_t = _to_torch(p_j)
    _, s_j = _jit(jssm.mamba_forward)(p_j, jnp.asarray(_x((2, 11, 64), 5)),
                                      cfg_j)
    s_t = ssm.MambaState(*(torch.from_numpy(np.array(a)) for a in s_j))
    x = _x((2, 1, 64), 6)
    y_j, n_j = _jit(jssm.mamba_decode)(p_j, jnp.asarray(x), cfg_j, s_j)
    y_t, n_t = ssm.mamba_decode(p_t, torch.from_numpy(x), cfg_t, s_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    _state_close(n_t, n_j)


def _xlstm():
    cfg_j = jax_get_config("xlstm_125m").smoke()
    return cfg_j, get_config("xlstm_125m").smoke()


@pytest.mark.parametrize("S", [16, 21, 1])
def test_mlstm_forward_matches_jax(S):
    cfg_j, cfg_t = _xlstm()
    p_j = jssm.init_mlstm_params(jax.random.key(3), cfg_j, jnp.float32)
    x = _x((2, S, cfg_j.d_model), S + 7)
    y_j, s_j = _jit(jssm.mlstm_forward)(p_j, jnp.asarray(x), cfg_j)
    y_t, s_t = ssm.mlstm_forward(_to_torch(p_j), torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    _state_close(s_t, s_j)
    # decode from that state, one token
    x1 = _x((2, 1, cfg_j.d_model), 9)
    y_j, n_j = _jit(jssm.mlstm_decode)(p_j, jnp.asarray(x1), cfg_j, s_j)
    y_t, n_t = ssm.mlstm_decode(_to_torch(p_j), torch.from_numpy(x1), cfg_t,
                                s_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    _state_close(n_t, n_j)


def test_mlstm_chunkwise_equals_its_step_recurrence():
    """The chunkwise form against the port's own ``_mlstm_step`` run token
    by token on the same q, k, v and gates (the readout before the norm
    and the state)."""
    _, cfg = _xlstm()
    g = torch.Generator().manual_seed(0)
    p = ssm.init_mlstm_params(cfg, torch.float32, g, "cpu")
    B, S = 2, 19
    d_inner, nh, P = ssm.xlstm_dims(cfg)
    x = torch.randn((B, S, cfg.d_model), generator=g)
    xin, _ = (x @ p["w_up"]).chunk(2, dim=-1)
    qkv = (xin @ p["wqkv"]).reshape(B, S, 3, nh, P)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1] / P ** 0.5, qkv[:, :, 2]
    gates = ((xin @ p["w_gates"]) + p["gate_b"]).reshape(B, S, 2, nh)
    st = ssm.init_mlstm_state(cfg, B, "cpu")
    ys = []
    for t in range(S):
        st, y = ssm._mlstm_step(st, q[:, t], k[:, t], v[:, t],
                                gates[:, t, 0], gates[:, t, 1])
        ys.append(y)
    want = torch.stack(ys, 1).reshape(B, S, d_inner)
    # the chunkwise readout: the block's output before mem_norm, one
    # capture for the 16 chunked tokens and one for the remainder's 3
    captured = []
    real_norm = ssm.rms_norm

    def spy(y, gamma, eps):
        captured.append(y)
        return real_norm(y, gamma, eps)
    ssm.rms_norm = spy
    try:
        _, st_c = ssm.mlstm_forward(p, x, cfg)
    finally:
        ssm.rms_norm = real_norm
    assert [c.shape[1] for c in captured] == [16, 3]
    torch.testing.assert_close(torch.cat(captured, 1), want, rtol=1e-4,
                               atol=1e-4)
    # the two forms stabilise the memory by different m (C e^m and n e^m
    # are the memory itself), and the chunkwise form keeps C as k v^T where
    # the step keeps v k^T, as in JAX (neither mixes with the other)
    for a, b in ((st_c.C * st_c.m.exp()[..., None, None],
                  (st.C * st.m.exp()[..., None, None]).transpose(-1, -2)),
                 (st_c.n * st_c.m.exp()[..., None], st.n * st.m.exp()[..., None])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [1, 13])
def test_slstm_forward_matches_jax(S):
    cfg_j, cfg_t = _xlstm()
    p_j = jssm.init_slstm_params(jax.random.key(4), cfg_j, jnp.float32)
    x = _x((2, S, cfg_j.d_model), S + 11)
    y_j, s_j = _jit(jssm.slstm_forward)(p_j, jnp.asarray(x), cfg_j)
    y_t, s_t = ssm.slstm_forward(_to_torch(p_j), torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    _state_close(s_t, s_j)
    x1 = _x((2, 1, cfg_j.d_model), 12)
    y_j, n_j = _jit(jssm.slstm_decode)(p_j, jnp.asarray(x1), cfg_j, s_j)
    y_t, n_t = ssm.slstm_decode(_to_torch(p_j), torch.from_numpy(x1), cfg_t,
                                s_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
    _state_close(n_t, n_j)


def test_causal_conv1d_matches_jax():
    x, w, b = _x((2, 9, 12), 1), _x((4, 12), 2), _x((12,), 3)
    st = _x((2, 3, 12), 4)
    for state in (None, st):
        y_j, n_j = jssm.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state))
        y_t, n_t = ssm.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32)
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


# ---------------------------------------------------------------------------
# the unified LM, every ARCH_ID on smoke()
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32"):
    """JAX's smoke model, its parameters carried across, and one batch:
    B 2, 20 positions (frontend included), a remainder chunk for the SSM
    scans (chunk 8) and two KV chunks (attn_chunk 16) with a padded one."""
    jc = dataclasses.replace(jax_get_config(arch).smoke(), dtype=dtype)
    tc = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    p_j = jlm.init_params(jax.random.key(0), jc)
    p_t = _to_torch(p_j)
    rng = np.random.default_rng(0)
    F = jc.frontend_len if jc.frontend else 0
    toks = rng.integers(0, jc.vocab, (2, 20 - F))
    fe = (rng.standard_normal((2, F, jc.d_model)).astype(np.float32) * 0.02
          if F else None)
    nxt = rng.integers(0, jc.vocab, (2, 1))
    return jc, tc, p_j, p_t, toks, fe, nxt


def _fe(fe, jax_side):
    if fe is None:
        return None
    return jnp.asarray(fe) if jax_side else torch.from_numpy(fe)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype="float32"):
    jc, _, p_j, _, toks, fe, nxt = _model(arch, dtype)

    @jax.jit
    def run(p, toks, fe, nxt):
        logits = jlm.forward(p, toks, jc, fe)
        lp, cache = jlm.prefill(p, toks, jc, 32, fe)
        ld, cache2 = jlm.decode_step(p, nxt, cache, jc)
        return logits, lp, cache, ld, cache2
    return run(p_j, jnp.asarray(toks), _fe(fe, True), jnp.asarray(nxt))


def _port_run(arch, dtype="float32"):
    _, tc, _, p_t, toks, fe, nxt = _model(arch, dtype)
    logits = lm.forward(p_t, torch.from_numpy(toks), tc, _fe(fe, False))
    lp, cache = lm.prefill(p_t, torch.from_numpy(toks), tc, 32,
                           _fe(fe, False))
    ld, cache2 = lm.decode_step(p_t, torch.from_numpy(nxt), cache, tc)
    return logits, lp, cache, ld, cache2


def _caches_close(got, want):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), **F32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch):
    want = _jax_run(arch)[0]
    got = _port_run(arch)[0]
    assert got.shape == want.shape == (2, 20, lm.vocab_padded(
        _model(arch)[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_logits_and_caches_match_jax(arch):
    _, lp_j, c_j, _, _ = _jax_run(arch)
    _, lp_t, c_t, _, _ = _port_run(arch)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), **F32)
    _caches_close(c_t, c_j)
    assert int(c_t.pos) == int(c_j.pos) == 20


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_jax(arch):
    *_, ld_j, c2_j = _jax_run(arch)
    _, _, c_t, ld_t, c2_t = _port_run(arch)
    np.testing.assert_allclose(ld_t.numpy(), np.asarray(ld_j), **F32)
    _caches_close(c2_t, c2_j)
    assert int(c2_t.pos) == 21 and int(c_t.pos) == 20   # functional


@pytest.mark.parametrize("arch", ["qwen3_8b", "dbrx_132b"])
def test_bf16_model_matches_jax(arch):
    """bf16 (the full configs' dtype): forward, prefill and decode logits
    within 2e-2 x max|logit|; the caches keep the run dtype."""
    want = _jax_run(arch, "bfloat16")
    got = _port_run(arch, "bfloat16")
    assert got[0].dtype == torch.bfloat16
    for i in (0, 1, 3):
        _close_logits(got[i], want[i], "bfloat16")
    assert [a.dtype for a in _leaves(got[4])] == [
        getattr(torch, str(np.asarray(b).dtype)) for b in _leaves(want[4])]


def test_bf16_hybrid_blocks_match_jax():
    """zamba2's bf16 smoke model block by block: at every layer the shared
    attention+MLP block, the Mamba2 block (forward) and its decode step
    get JAX's own bf16 activations and state, and each output is held
    within 2e-2 x its max|out|. The whole model is not held at that
    gate: XLA on the CPU evaluates bf16 elementwise chains with its own
    roundings (its bf16 logistic alone is one ulp off the exactly
    rounded one for 5 % of inputs), each block differs by 0.4-0.9 % of
    its max, and six blocks compound that to 3.2 % of max|logit|, where
    JAX's own bf16 logits are 4.7 % from its fp32 ones."""
    jc, tc, p_j, p_t, toks, _, _ = _model("zamba2_1p2b", "bfloat16")
    shared = jax.jit(jlm._shared_block_fwd, static_argnums=2)
    norm = jax.jit(jlm.rms_norm, static_argnums=2)
    x = jnp.take(p_j["embed"], jnp.asarray(toks), axis=0)
    B, S = toks.shape
    pos_j = jnp.broadcast_to(jnp.arange(S), (B, S))
    pos_t = torch.arange(S).expand(B, S)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)
    x1 = _x((B, 1, jc.d_model), 13)
    for i in range(jc.n_layers):
        if i % jc.attn_every == 0:
            want = shared(p_j["shared"], x, jc, pos_j)
            got = lm._shared_block_fwd(p_t["shared"], t(x), tc, pos_t)
            assert got.dtype == torch.bfloat16
            _close_logits(got, want, "bfloat16")
            x = want
        bp_j = jax.tree.map(lambda a: a[i], p_j["blocks"])
        bp_t = lm._layer(p_t["blocks"], i)
        normed = norm(x, bp_j["ln"], jc.norm_eps)
        h_j, st_j = _jit(jssm.mamba_forward)(bp_j["mamba"], normed, jc)
        h_t, _ = ssm.mamba_forward(bp_t["mamba"], t(normed), tc)
        _close_logits(h_t, h_j, "bfloat16")
        xd = jnp.asarray(x1).astype(jnp.bfloat16)
        d_j, _ = _jit(jssm.mamba_decode)(bp_j["mamba"], xd, jc, st_j)
        d_t, _ = ssm.mamba_decode(bp_t["mamba"], t(xd), tc, ssm.MambaState(
            torch.from_numpy(np.asarray(st_j.ssm)), t(st_j.conv)))
        _close_logits(d_t, d_j, "bfloat16")
        x = x + h_j


def test_params_from_jax_keeps_the_tree_and_dtypes():
    _, _, p_j, p_t, *_ = _model("zamba2_1p2b", "bfloat16")
    flat_j = jax.tree_util.tree_leaves_with_path(p_j)
    flat_t = dict(lm.tree_leaves(p_t))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        t = flat_t[tuple(e.key for e in path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
        assert torch.equal(t.float(), torch.from_numpy(
            np.asarray(leaf, np.float32)))


@pytest.mark.parametrize("arch", ["qwen3_8b", "zamba2_1p2b", "xlstm_125m",
                                  "dbrx_132b"])
def test_init_params_has_jax_shapes_and_dtypes(arch):
    """The port's own init (a torch generator) builds JAX's tree: the
    same paths, shapes and dtypes, blocks stacked on a leading axis."""
    jc = jax_get_config(arch).smoke()
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0), jc))
    want = {tuple(e.key for e in p): (leaf.shape, str(leaf.dtype))
            for p, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    p = lm.init_params(get_config(arch).smoke(),
                       torch.Generator().manual_seed(0), "cpu")
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in lm.tree_leaves(p)}
    assert got == want
