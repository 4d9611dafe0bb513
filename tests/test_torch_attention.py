"""The port's attention slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both sides. On CPU
tensors the port's kernel wrappers run their plain versions; the JAX
side runs its Pallas kernels in interpret mode. Tolerances are the
reference's own (``tests/test_kernels.py:17-19``): 1e-4 in fp32, 2e-2 in
bf16; the decode caches are compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import layers

DTYPES = {"f32": (jnp.float32, torch.float32, dict(rtol=1e-4, atol=1e-4)),
          "bf16": (jnp.bfloat16, torch.bfloat16, dict(rtol=2e-2, atol=2e-2))}


def _both(a, dt="f32"):
    jdt, tdt, _ = DTYPES[dt]
    a = np.ascontiguousarray(a, np.float32)
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3_8b", "qwen3-8b"])
def test_qwen3_8b_config_matches_jax(name):
    """The port's ModelConfig carries every JAX field, and each equals
    JAX's, in the config and in its smoke() reduction."""
    want = jax_get_config(name)
    got = get_config(name)
    for g, w in ((got, want), (got.smoke(), want.smoke())):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert (got.d_head, got.n_heads // got.n_kv_heads) == (128, 4)


# ---------------------------------------------------------------------------
# ops.attention (flash_attention) and its oracle
# ---------------------------------------------------------------------------

ATTN_SHAPES = [            # tests/test_kernels.py:125-129, plus one GQA case
    (1, 2, 2, 32, 16, 16, 16),
    (2, 4, 4, 64, 32, 16, 32),
    (1, 1, 1, 128, 64, 128, 64),
    (1, 4, 2, 32, 16, 16, 16),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,bq,bk", ATTN_SHAPES)
@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel", "oracle"])
def test_ops_attention_matches_jax(B, Hq, Hkv, S, D, bq, bk, dt,
                                   use_kernels):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((B, Hq, S, D)), dt)
    kj, kt = _both(rng.standard_normal((B, Hkv, S, D)), dt)
    vj, vt = _both(rng.standard_normal((B, Hkv, S, D)), dt)
    want = jops.attention(qj, kj, vj, use_pallas=use_kernels, bq=bq, bk=bk)
    n0 = (flash_attention.launches, flash_attention.launches_bf16)
    got = ops.attention(qt, kt, vt, use_kernels=use_kernels)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **DTYPES[dt][2])
    # on CPU tensors the wrapper runs the plain version: nothing launches
    assert (flash_attention.launches, flash_attention.launches_bf16) == n0


def test_flash_attention_takes_equal_query_and_key_lengths():
    """The kernel masks k_pos > q_pos and its oracle tril(k=Sk-Sq): they
    agree only at Sq == Sk, so the wrapper refuses other lengths on every
    device, while the oracle path (use_kernels=False) takes them as JAX's
    does."""
    q = torch.zeros((1, 2, 16, 16))
    k = torch.zeros((1, 2, 24, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        ops.attention(q, k, k)
    assert ops.attention(q, k, k, use_kernels=False).shape == q.shape


def test_flash_attention_plain_is_causal():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 32, 16))
                                .astype(np.float32)) for _ in range(3))
    o1 = flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 20:] = 99.0
    v2[:, :, 20:] = -99.0
    o2 = flash_attention(q, k2, v2)
    np.testing.assert_allclose(o1[:, :, :20], o2[:, :, :20], atol=1e-5)


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _decode_inputs(rng, B, S, HKV, G, D, dt):
    return [_both(rng.standard_normal(s), dt) for s in (
        (B, HKV, G, D), (B, S, HKV, D), (B, S, HKV, D), (B, HKV, D),
        (B, HKV, D))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,HKV,G,D,bs,pos", [   # tests/test_kernels.py:159-164
    (1, 32, 2, 2, 16, 16, 7),
    (2, 64, 4, 2, 16, 16, 37),
    (2, 128, 2, 4, 32, 64, 127),
    (1, 64, 1, 8, 16, 64, 0),
])
@pytest.mark.parametrize("pos_tensor", [False, True], ids=["int", "tensor"])
def test_decode_attention_matches_jax(B, S, HKV, G, D, bs, pos, dt,
                                      pos_tensor):
    rng = np.random.default_rng(2)
    ins = _decode_inputs(rng, B, S, HKV, G, D, dt)
    o_j, k_j, v_j = jax_decode(*[j for j, _ in ins], jnp.asarray(pos), bs=bs)
    p = torch.tensor(pos, dtype=torch.int32) if pos_tensor else pos
    o_t, k_t, v_t = decode_attention(*[t for _, t in ins], p)
    np.testing.assert_allclose(_np(o_t), _np(o_j), **DTYPES[dt][2])
    np.testing.assert_array_equal(_np(k_t), _np(k_j))
    np.testing.assert_array_equal(_np(v_t), _np(v_j))
    o_r, k_r, v_r = ref.decode_attention_ref(*[t for _, t in ins], pos)
    np.testing.assert_allclose(_np(o_t), _np(o_r), **DTYPES[dt][2])


def test_decode_attention_writes_slot_pos_in_place_only():
    rng = np.random.default_rng(3)
    _, q, kc, vc, nk, nv = [None] + [t for _, t in _decode_inputs(
        rng, 2, 64, 2, 4, 16, "f32")]
    k0, v0 = kc.clone(), vc.clone()
    o, k_out, v_out = decode_attention(q, kc, vc, nk, nv, 37)
    assert k_out is kc and v_out is vc
    others = [s for s in range(64) if s != 37]
    assert torch.equal(kc[:, others], k0[:, others])
    assert torch.equal(vc[:, others], v0[:, others])
    assert torch.equal(kc[:, 37], nk) and torch.equal(vc[:, 37], nv)
    # the functional oracle leaves its inputs alone and agrees
    o_r, k_r, _ = ref.decode_attention_ref(q, k0, v0, nk, nv, 37)
    assert torch.equal(k_r, kc) and not torch.equal(k0, kc)
    torch.testing.assert_close(o, o_r, rtol=1e-4, atol=1e-4)


def test_decode_attention_ignores_stale_future_slots():
    """Slots past `pos` (stale values from earlier sequences) must not
    affect the output (tests/test_kernels.py:184-200)."""
    rng = np.random.default_rng(4)
    q, kc, vc, nk, nv = [t for _, t in _decode_inputs(rng, 1, 64, 2, 2, 16,
                                                      "f32")]
    o1, _, _ = decode_attention(q, kc.clone(), vc.clone(), nk, nv, 20)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 30:] = 77.0
    vc2[:, 30:] = -77.0
    o2, _, _ = decode_attention(q, kc2, vc2, nk, nv, 20)
    np.testing.assert_allclose(o1, o2, atol=1e-6)


# ---------------------------------------------------------------------------
# models/layers and models/attention on Qwen3-8B smoke
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(5)
    xj, xt = _both(rng.standard_normal((2, 7, 4, 16)))
    gj, gt = _both(rng.standard_normal(16))
    np.testing.assert_allclose(_np(layers.rms_norm(xt, gt, 1e-6)),
                               _np(jlayers.rms_norm(xj, gj, 1e-6)),
                               rtol=1e-5, atol=1e-6)
    pos = np.arange(3, 10)[None].repeat(2, 0)
    np.testing.assert_allclose(
        _np(layers.apply_rope(xt, torch.from_numpy(pos), 1e6)),
        _np(jlayers.apply_rope(xj, jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)


def _layer(impl="chunked", dtype="float32"):
    cfg = jax_get_config("qwen3_8b").smoke()
    cfg = dataclasses.replace(cfg, attention_impl=impl, dtype=dtype)
    p_j = jattn.init_attn_params(jax.random.key(0), cfg,
                                 jlayers.dtype_of(dtype))
    p_t = attn.params_from_jax({k: np.asarray(v) for k, v in p_j.items()},
                               "cpu")
    tcfg = dataclasses.replace(get_config("qwen3_8b").smoke(),
                               attention_impl=impl, dtype=dtype)
    return cfg, tcfg, p_j, p_t


@pytest.mark.parametrize("S,impl", [(12, "chunked"),     # naive: S <= chunk
                                    (32, "chunked"),     # chunked, 2 chunks
                                    (40, "chunked"),     # chunked, padded
                                    (40, "naive")])
def test_attn_forward_matches_jax(S, impl):
    cfg, tcfg, p_j, p_t = _layer(impl)
    rng = np.random.default_rng(6)
    xj, xt = _both(rng.standard_normal((2, S, cfg.d_model)))
    want = jattn.attn_forward(p_j, xj, cfg)
    got = attn.attn_forward(p_t, xt, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def test_attn_forward_bf16_matches_jax():
    cfg, tcfg, p_j, p_t = _layer("chunked", "bfloat16")
    assert p_t["wq"].dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    xj, xt = _both(rng.standard_normal((1, 40, cfg.d_model)), "bf16")
    want = jattn.attn_forward(p_j, xj, cfg)
    got = attn.attn_forward(p_t, xt, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("pos", [0, 5, 31])
def test_attn_decode_matches_jax(pos):
    cfg, tcfg, p_j, p_t = _layer()
    rng = np.random.default_rng(8)
    S = 32
    kc_j, kc_t = _both(rng.standard_normal((2, S, 2, 16)))
    vc_j, vc_t = _both(rng.standard_normal((2, S, 2, 16)))
    xj, xt = _both(rng.standard_normal((2, 1, cfg.d_model)))
    y_j, c_j = jattn.attn_decode(p_j, xj, cfg, jattn.KVCache(kc_j, vc_j),
                                 jnp.asarray(pos, jnp.int32))
    y_t, c_t = attn.attn_decode(p_t, xt, tcfg, attn.KVCache(kc_t, vc_t),
                                torch.tensor(pos))
    np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(c_t.k), _np(c_j.k), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(_np(c_t.v), _np(c_j.v))


def test_attn_decode_through_the_kernel_matches_the_layer():
    """The layer's decode equals projections -> decode_attention -> wo,
    the composition chip_smoke.py runs on the card."""
    _, tcfg, _, p = _layer()
    rng = np.random.default_rng(9)
    cache = attn.init_kv_cache(tcfg, 2, 32, torch.float32, device="cpu")
    cache.k.copy_(torch.from_numpy(rng.standard_normal(cache.k.shape)))
    cache.v.copy_(torch.from_numpy(rng.standard_normal(cache.v.shape)))
    x = torch.from_numpy(rng.standard_normal((2, 1, tcfg.d_model))
                         .astype(np.float32))
    want, new = attn.attn_decode(p, x, tcfg, cache, 17)
    positions = torch.full((2, 1), 17)
    q, k, v = attn._project_qkv(p, x, tcfg, positions)
    g = tcfg.n_heads // tcfg.n_kv_heads
    o, kc, vc = decode_attention(q.reshape(2, tcfg.n_kv_heads, g, 16),
                                 cache.k.clone(), cache.v.clone(),
                                 k[:, 0].contiguous(), v[:, 0].contiguous(),
                                 17)
    got = o.reshape(2, 1, -1) @ p["wo"]
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(kc, new.k) and torch.equal(vc, new.v)


def test_init_kv_cache_defaults_to_the_card(monkeypatch):
    """Like the port's other entry points, the cache lands on the CUDA
    device unless the caller names another, and raises without one."""
    cfg = get_config("qwen3_8b").smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attn.init_kv_cache(cfg, 1, 8, torch.float32)
    cache = attn.init_kv_cache(cfg, 2, 8, torch.bfloat16, device="cpu")
    assert cache.k.shape == (2, 8, cfg.n_kv_heads, cfg.d_head)
    assert cache.v.dtype == torch.bfloat16 and not cache.k.any()
