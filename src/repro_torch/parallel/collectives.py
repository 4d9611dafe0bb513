"""Explicit-collective building blocks over ``torch.distributed``: the
hill-climb levers of the JAX package's ``parallel/collectives.py``.

JAX writes them with ``shard_map`` over a mesh axis; here each rank calls
them with its own shards, and the axis is a ``DeviceMesh`` dimension
(``mesh`` and ``axis``), or the whole world when no mesh is given.

* :func:`ring_matmul_overlapped`: the all-gather x matmul overlap. Each
  ring step posts the next block's send and receive
  (``batch_isend_irecv``) before it multiplies the block it holds, so the
  hop is in flight during the product. (PipeCNN analogue: MemRD streams
  the next tile while the CU computes the current one.)
* :func:`sp_decode_attention`: sequence-parallel one-token attention with
  the explicit two-scalar (m, l) online-softmax combine over the KV
  shards, split into :func:`sp_decode_partial` (one shard's statistics)
  and the all-reduces; :func:`sp_decode_combine` is the same combine over
  partials held in one process (``chip_smoke.py`` phase 19 runs it over
  slices of one card's cache).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["ring_matmul_overlapped", "sp_decode_attention",
           "sp_decode_combine", "sp_decode_partial"]

_Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _group(mesh, axis: str):
    return dist.group.WORLD if mesh is None else mesh.get_group(axis)


def ring_matmul_overlapped(x: torch.Tensor, w: torch.Tensor, mesh=None,
                           axis: str = "model") -> torch.Tensor:
    """y = x @ w with x gathered ring-wise and overlapped.

    x: this rank's (M/n, K) block of rows; w: its (K, N/n) block of
    columns (Megatron column parallel). Returns this rank's (M, N/n)
    columns of the product, accumulated in fp32 and cast to x's dtype.
    After i steps of the ring (block j+1 -> rank j) the rank holds the
    block of rank (idx + i) % n, as in JAX's ppermute schedule."""
    group = _group(mesh, axis)
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    m = x.shape[0]
    out = torch.empty((m * n, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    to = dist.get_global_rank(group, (idx - 1) % n)
    frm = dist.get_global_rank(group, (idx + 1) % n)
    blk, w32 = x.contiguous(), w.float()
    for i in range(n):
        src = (idx + i) % n
        reqs = []
        if i < n - 1:                   # the next block, in flight now
            nxt = torch.empty_like(blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, blk, to, group),
                dist.P2POp(dist.irecv, nxt, frm, group)])
        out[src * m:(src + 1) * m] = blk.float() @ w32
        for r in reqs:
            r.wait()
        if reqs:
            blk = nxt
    return out.to(x.dtype)


def sp_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos, offset: int) -> _Stats:
    """One KV shard's online-softmax statistics for one query token.

    q (B, H, D); k, v (B, s, H, D), the cache's slots ``offset ..
    offset + s - 1``; slots past ``pos`` are masked. Returns (m (B, H),
    l (B, H), o (B, H, D)), all fp32: the row max, the sum of
    ``exp(s - m)`` and the unnormalised output."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kpos = offset + torch.arange(k.shape[1], device=k.device)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    s = torch.where((kpos <= pos)[None, None, :], s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p.sum(dim=-1), torch.einsum("bhs,bshd->bhd", p, v.float())


def sp_decode_combine(parts: Sequence[_Stats]) -> torch.Tensor:
    """The combine of :func:`sp_decode_attention` over partials held in
    one process: the max of the m's, each shard's l and o rescaled by
    exp(m - max) and summed. Returns o (B, H, D) in fp32."""
    m = torch.stack([p[0] for p in parts])
    m_g = m.amax(dim=0)
    corr = torch.exp(m - m_g)
    l_g = (torch.stack([p[1] for p in parts]) * corr).sum(dim=0)
    o_g = (torch.stack([p[2] for p in parts]) * corr[..., None]).sum(dim=0)
    return o_g / torch.clamp_min(l_g, 1e-30)[..., None]


def sp_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, pos, mesh=None,
                        axis: str = "model") -> torch.Tensor:
    """Sequence-parallel one-token attention with explicit (m, l) combine.

    q: (B, H, D), the same on every rank; k_cache/v_cache: this rank's
    (B, S/n, H, D) slice of the sequence (rank r holds slots r·S/n ..).
    Each rank computes its partial statistics, then the combine moves
    only (B, H) scalars and (B, H, D) vectors: an all-reduce MAX of m and
    two all-reduce SUMs."""
    group = _group(mesh, axis)
    s_loc = k_cache.shape[1]
    m, l, o = sp_decode_partial(q, k_cache, v_cache, pos,
                                dist.get_rank(group) * s_loc)
    m_g = m.clone()
    dist.all_reduce(m_g, dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    l_g, o_g = l * corr, o * corr[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(o_g, group=group)
    return (o_g / torch.clamp_min(l_g, 1e-30)[..., None]).to(q.dtype)
