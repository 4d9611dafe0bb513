"""GQA attention: chunked online-softmax (flash-style) + decode with KV cache.

A copy of the JAX package's ``models/attention.py``, the plain layer that is
the oracle of the attention kernels: plain PyTorch, as the JAX layer is
plain XLA. The chunked path never builds the (S x S) score matrix; a KV
chunk's scores live only inside one loop step. The kernels themselves sit
behind :func:`repro_torch.kernels.ops.attention` and
:func:`repro_torch.kernels.decode_attention.decode_attention`.

Weights are stored FLAT, (D, Hq*dh) etc., as in the JAX package, so
:func:`params_from_jax` needs no transpose. The JAX layer's sharding
annotations are dropped: on one device they are no-ops.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.pipeline.compile import resolve_device

NEG_INF = -1e30

Params = Dict[str, torch.Tensor]


def init_attn_params(cfg: ModelConfig, dtype: torch.dtype,
                     generator: torch.Generator, device=None) -> Params:
    """Random layer weights from ``generator``, scaled as the JAX
    package's ``init_attn_params`` scales them (normal / sqrt(fan_in),
    norms at one). torch's generator cannot reproduce ``jax.random``: to
    compare with JAX, carry its parameters across with
    :func:`params_from_jax`."""
    device = generator.device if device is None else device
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {name: dense_init(shape, dtype, generator, device)
         for name, shape in (("wq", (d, hq * dh)), ("wk", (d, hkv * dh)),
                             ("wv", (d, hkv * dh)), ("wo", (hq * dh, d)))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(dh, dtype=dtype, device=device)
        p["k_norm"] = torch.ones(dh, dtype=dtype, device=device)
    return p


def params_from_jax(p, device):
    """The JAX package's parameters (a dict of numpy arrays, or anything
    ``np.asarray`` takes, nested to any depth: a layer's dict or a whole
    model's tree) as the port's, on ``device``, in the same dtypes (bf16
    goes through fp32, which holds it exactly). No transposes."""
    if isinstance(p, dict):
        return {name: params_from_jax(a, device) for name, a in p.items()}
    a = np.asarray(p)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,Hq,dh), k/v (B,S,Hkv,dh), rope + qk_norm applied."""
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, hq, dh)
    k = (x @ p["wk"]).reshape(B, S, hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa_naive(q, k, v, cfg: ModelConfig, causal: bool = True):
    """Reference full-matrix attention (smoke tests / oracle)."""
    B, Sq, hq, dh = q.shape
    Sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(dh)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(Sk - Sq)
        s = s.masked_fill(~mask, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pattn, v.float())
    return o.reshape(B, Sq, hq, dh).to(q.dtype)


def _sdpa_chunked(q, k, v, cfg: ModelConfig):
    """Online-softmax causal attention, looped over KV chunks.

    Never materializes (Sq x Sk); per-step live memory is O(Sq * chunk).
    """
    B, Sq, hq, dh = q.shape
    Sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    C = min(cfg.attn_chunk, Sk)
    if Sk % C:      # pad KV to a chunk multiple; causal mask hides the pad
        pad = C - Sk % C
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        Sk += pad

    qg = q.reshape(B, Sq, hkv, g, dh).float()
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, hkv, g, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, hkv, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, hkv, g, Sq, dh), dtype=torch.float32,
                      device=q.device)
    for j in range(Sk // C):
        kj, vj = k[:, j * C:(j + 1) * C], v[:, j * C:(j + 1) * C]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.float())
        s = s / math.sqrt(dh)
        k_pos = j * C + torch.arange(C, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]            # causal
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vj.dtype).float(), vj.float())
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, hq, dh).to(q.dtype)


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal attention (training / prefill)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if cfg.attention_impl == "naive" or S <= min(cfg.attn_chunk, 1024):
        o = _sdpa_naive(q, k, v, cfg)
    else:
        o = _sdpa_chunked(q, k, v, cfg)
    return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]


class KVCache(NamedTuple):
    """Per-layer KV cache."""
    k: torch.Tensor                  # (B, S_max, hkv, dh)
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, s_max: int,
                  dtype: torch.dtype, device=None,
                  n_layers: Optional[int] = None) -> KVCache:
    """Zeroed caches on ``device``: the CUDA device by default, which
    raises when there is none (pass ``device="cpu"``). With ``n_layers``
    they are stacked, ``(n_layers, batch, s_max, Hkv, dh)``, as the JAX
    package's are."""
    device = resolve_device(device)
    shape = ((n_layers,) if n_layers else ()) + (
        batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def attn_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                cache: KVCache, pos: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x (B,1,D); pos an int or a 0-d integer tensor
    (tokens so far). Functional, as in JAX: returns a new cache."""
    B = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    pos_t = torch.as_tensor(pos, device=x.device)
    positions = pos_t.reshape(1, 1).expand(B, 1).to(torch.int32)
    q, k, v = _project_qkv(p, x, cfg, positions)

    S = cache.k.shape[1]
    slots = torch.arange(S, device=x.device)
    at_pos = (slots == pos_t)[None, :, None, None]
    ck = torch.where(at_pos, k.to(cache.k.dtype), cache.k)
    cv = torch.where(at_pos, v.to(cache.v.dtype), cache.v)

    g = hq // hkv
    qg = q.reshape(B, hkv, g, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     ck.float()) / math.sqrt(dh)
    valid = (slots <= pos_t)[None, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", pattn.to(cv.dtype).float(),
                     cv.float())
    o = o.reshape(B, 1, hq * dh).to(x.dtype)
    return o @ p["wo"], KVCache(ck, cv)
