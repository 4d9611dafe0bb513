"""GQA attention: chunked online-softmax (flash-style) + decode with KV cache.

A copy of the JAX package's ``models/attention.py``, the plain layer that is
the oracle of the attention kernels: plain PyTorch, as the JAX layer is
plain XLA. The chunked path never builds the (S x S) score matrix; a KV
chunk's scores live only inside one loop step. The kernels themselves sit
behind :func:`repro_torch.kernels.ops.attention` and
:func:`repro_torch.kernels.decode_attention.decode_attention`.

Weights are stored FLAT, (D, Hq*dh) etc., as in the JAX package, so
:func:`params_from_jax` needs no transpose. The JAX layer's sharding
annotations (``parallel.sharding.shard``) sit where JAX has them and act
only inside the dry run's ``sharding_ctx``. Each split of a flat head
dimension goes through ``sharding.unflatten``: where GQA's 8 KV heads do
not divide TP = 16, DTensor cannot view a shard that holds part of a head
and gathers the dimension first, the collective GSPMD inserts unasked.
The attention core runs ``sharding.per_shard`` over the batch, the
queries and the query heads, as JAX's query is cut (its sequence where
the "seq" rule cuts it, each rank masking from its own first query), with
K and V cut on the batch only:
each rank maps its own heads ``lo .. lo+n-1`` to their KV heads
``(lo + i) // g``, in (KV head, group) blocks where its range holds whole
groups and head by head where it does not (DTensor cannot view a cut head
dim as (KV head, group); GSPMD tiles it). Decode's query is cut as the
cache is (``sharding.align``): GSPMD reshards one side of a product on
its own, DTensor refuses.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.parallel.sharding import (align, flatten, full, matmul,
                                           per_shard, shard, unflatten)
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
    q = unflatten(matmul(x, p["wq"]), 2, (hq, dh))
    k = unflatten(matmul(x, p["wk"]), 2, (hkv, dh))
    v = unflatten(matmul(x, p["wv"]), 2, (hkv, dh))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", None, None)
    v = shard(v, "batch", "seq", None, None)
    return q, k, v


def _sdpa_naive(q, k, v, cfg: ModelConfig, causal: bool = True):
    """Reference full-matrix attention (smoke tests / oracle)."""
    return per_shard(_own_heads, q, k, v, dims=(0, 1, 2), shape=q.shape,
                     arg_dims=((0, None, None),) * 2, offsets=True,
                     core=_naive, g=q.shape[2] // k.shape[2], causal=causal,
                     q_len=q.shape[1])


def _own_heads(q, k, v, offsets, core, g: int, **kw):
    """``core`` on this rank's queries ``q0 ..`` and query heads ``lo ..
    lo+n-1`` (q (B, Sq, n, dh), ``offsets`` its starts along the batch,
    the sequence and the heads) against whole K and V (B, Sk, Hkv, dh), as
    (KV head, group) blocks where the range holds whole groups of ``g``,
    else one KV head a query head (a range that straddles groups, or lies
    inside one) -> (B, Sq, n, dh)."""
    q0, lo, n = offsets[1], offsets[2], q.shape[2]
    if lo % g == 0 and n % g == 0:
        h0, h1 = lo // g, (lo + n) // g
        return core(q.unflatten(2, (n // g, g)), k[:, :, h0:h1],
                    v[:, :, h0:h1], q0=q0, **kw)
    kv = torch.arange(lo, lo + n, device=q.device) // g
    return core(q.unsqueeze(3), k[:, :, kv], v[:, :, kv], q0=q0, **kw)


def _naive(qg, k, v, causal: bool, q0: int = 0,
           q_len: Optional[int] = None):
    """Queries ``q0 ..`` of ``q_len`` (default: all of them, the last
    ``Sq`` of the ``Sk`` positions)."""
    B, Sq, hkv, g, dh = qg.shape
    Sk = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(dh)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=qg.device
                          ).tril(q0 + Sk - (q_len or Sq))
        s = s.masked_fill(~mask, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", pattn, v.float())
    return o.reshape(B, Sq, hkv * g, dh).to(qg.dtype)


def _sdpa_chunked(q, k, v, cfg: ModelConfig):
    """Online-softmax causal attention, looped over KV chunks.

    Never materializes (Sq x Sk); per-step live memory is O(Sq * chunk).
    """
    return per_shard(_own_heads, q, k, v, dims=(0, 1, 2), shape=q.shape,
                     arg_dims=((0, None, None),) * 2, offsets=True,
                     core=_chunked, g=q.shape[2] // k.shape[2],
                     chunk=min(cfg.attn_chunk, k.shape[1]))


def _chunked(qg, k, v, chunk: int, q0: int = 0):
    """Queries ``q0 .. q0+Sq-1`` of as many as there are keys."""
    B, Sq, hkv, g, dh = qg.shape
    Sk = k.shape[1]
    C = chunk
    if Sk % C:      # pad KV to a chunk multiple; causal mask hides the pad
        pad = C - Sk % C
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        Sk += pad

    dtype, qg = qg.dtype, qg.float()
    q_pos = torch.arange(q0, q0 + Sq, device=qg.device)
    m = torch.full((B, hkv, g, Sq), NEG_INF, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((B, hkv, g, Sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, hkv, g, Sq, dh), dtype=torch.float32,
                      device=qg.device)
    for j in range(Sk // C):
        kj, vj = k[:, j * C:(j + 1) * C], v[:, j * C:(j + 1) * C]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.float())
        s = s / math.sqrt(dh)
        k_pos = j * C + torch.arange(C, device=qg.device)
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
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, hkv * g, dh).to(dtype)


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None,
                 return_kv: bool = False):
    """Full-sequence causal attention (training / prefill). With
    ``return_kv``, (output, k, v): the prefill's cache takes the K and V
    the attention used, where JAX projects them a second time and XLA
    merges the two."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if cfg.attention_impl == "naive" or S <= min(cfg.attn_chunk, 1024):
        o = _sdpa_naive(q, k, v, cfg)
    else:
        o = _sdpa_chunked(q, k, v, cfg)
    o = shard(o, "batch", "seq", "heads", None)
    out = matmul(flatten(o, 2, 3), p["wo"])
    return (out, k, v) if return_kv else out


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
    axes = (("layers",) if n_layers else ()) + ("batch", "kvseq", None, None)
    return KVCache(full(shape, 0, dtype, device, *axes),
                   full(shape, 0, dtype, device, *axes))


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
    ck = shard(ck, "batch", "kvseq", None, None)
    cv = shard(cv, "batch", "kvseq", None, None)

    g = hq // hkv
    qg = align(unflatten(q[:, 0], 1, (hkv, g)), ck, 1, 2)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     ck.float()) / math.sqrt(dh)
    valid = (slots <= pos_t)[None, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", pattn.to(cv.dtype).float(),
                     cv.float())
    o = o.reshape(B, 1, hq * dh).to(x.dtype)
    return matmul(o, p["wo"]), KVCache(ck, cv)
