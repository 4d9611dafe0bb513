"""Dense SwiGLU MLP and Mixture-of-Experts (capacity-based dispatch).

A copy of the JAX package's ``models/mlp.py`` in plain PyTorch, as the
JAX module is plain XLA (no kernel of the JAX package is on this path).

Dispatch is GShard-style and capacity-bounded: each (token, choice) goes
to its queue position in an (E, C, D) buffer a group; the expert GEMMs
run as one batched product; results are combined back with the routing
weights. Three places where torch differs from XLA and the code says so:

* ``jax.lax.top_k`` keeps the lower expert first on equal gates;
  ``torch.topk`` promises no order, so :func:`route_topk` takes the head
  of a stable descending sort.
* JAX's scatter drops a choice whose queue position is ``>= C``
  (``mode="drop"``); torch indexing raises there, so dropped choices
  write into one spare slot past the capacity that is cut off after.
* The combine is a sum over the K choices of a token, in fp32, in choice
  order (JAX's scatter-add into zeros); ``index_add_`` is not
  deterministic on CUDA and is not used.

JAX's sharding annotations (``parallel.sharding.shard``) sit where JAX has
them and act only inside the dry run's ``sharding_ctx``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import dense_init, swiglu
from repro_torch.parallel.sharding import (flatten, full, matmul,
                                           per_shard, shard, unflatten)

CAPACITY_FACTOR = 1.25

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Dense SwiGLU
# ---------------------------------------------------------------------------

def init_mlp_params(cfg: ModelConfig, dtype: torch.dtype,
                    generator: torch.Generator, device=None) -> Params:
    return {
        "wi": dense_init((cfg.d_model, 2 * cfg.d_ff), dtype, generator,
                         device),
        "wdown": dense_init((cfg.d_ff, cfg.d_model), dtype, generator,
                            device),
    }


def mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    # the input whole over "model" and the product cut on "ffn" (the dry
    # run): DTensor lays out a product by its inputs alone, and its
    # gradient by whatever reaches it (the swiglu split's is gathered),
    # where GSPMD propagates the ffn cut both ways
    x = shard(x, "batch", "seq", "embed")
    h = shard(matmul(x, p["wi"]), "batch", "seq", "ffn")
    h = shard(swiglu(h), "batch", "seq", "ffn")
    return matmul(h, p["wdown"])


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def init_moe_params(cfg: ModelConfig, dtype: torch.dtype,
                    generator: torch.Generator, device=None) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init((d, E), torch.float32, generator, device),
        "moe_wi": dense_init((E, d, 2 * f), dtype, generator, device),
        "moe_wdown": dense_init((E, f, d), dtype, generator, device),
    }
    if cfg.moe_dense_residual:       # Arctic: parallel dense path
        p.update(init_mlp_params(cfg, dtype, generator, device))
    return p


def route_topk(logits: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing. Returns (weights (T,k) fp32 summing to 1, idx (T,k)).

    Equal gates keep the lower expert first, as ``jax.lax.top_k`` does: a
    router of zeros picks experts 0..k-1."""
    gates = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    return w, idx


def expert_capacity(n_tokens: int, cfg: ModelConfig,
                    factor: float = CAPACITY_FACTOR) -> int:
    c = int(n_tokens * cfg.top_k * factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)                    # round up to 8


def moe_dispatch_indices(idx: torch.Tensor, E: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Position of each (token, k) routing choice within its expert queue.

    idx: (T, K) expert ids. Returns (e_flat (TK,), pos (TK,)): pos is the
    arrival order among all choices routed to the same expert, an
    exclusive running count of the one-hot over all T·K choices. JAX
    blocks that count for its SPMD partitioner; the integers are the
    same."""
    e_flat = idx.reshape(-1)
    oh = F.one_hot(e_flat, E)
    pos = (oh.cumsum(0) - oh).gather(1, e_flat[:, None])[:, 0]
    return e_flat, pos


def _dispatch(experts: torch.Tensor, xg: torch.Tensor, idx: torch.Tensor,
              E: int, C: int, offsets=(0, 0)):
    """Groups' tokens xg (G, Tl, D) into their experts' queues by idx (G,
    Tl, K): the queues of experts ``e0 .. e0+El-1`` (``offsets[1]`` and
    ``experts``' (G, El): a rank's own, as GSPMD scatters them; all E off
    a mesh) -> (buf (G, El, C, D), e_flat, pos (G, Tl*K)). A dropped
    choice (pos >= C), or one for another rank's expert, lands in a spare
    slot C, cut off after."""
    G, Tl, D = xg.shape
    e_flat, pos = zip(*(moe_dispatch_indices(i, E) for i in idx))
    e_flat, pos = torch.stack(e_flat), torch.stack(pos)
    e0, El = offsets[1], experts.shape[1]
    buf = torch.zeros((G, El, C + 1, D), dtype=xg.dtype, device=xg.device)
    if El:
        tok = torch.arange(Tl, device=xg.device).repeat_interleave(
            idx.shape[-1])
        g_ix = torch.arange(G, device=xg.device)[:, None]
        slot, e = pos.clamp_max(C), e_flat - e0
        if El < E:
            mine = (e >= 0) & (e < El)
            slot, e = torch.where(mine, slot, C), torch.where(mine, e, 0)
        buf[g_ix, e, slot] = xg[:, tok]
    return buf[:, :, :C], e_flat, pos


def _gather(o: torch.Tensor, e_flat: torch.Tensor, pos: torch.Tensor,
            E: int, C: int, offsets=(0, 0)) -> torch.Tensor:
    """Each choice's expert output (G, Tl*K, D) from o (G, El, C, D),
    experts ``e0 ..`` (``offsets[1]``; all E off a mesh). A choice for
    another rank's expert reads zero: the ranks' shares sum to the whole,
    GSPMD's masked gather."""
    e0, El = offsets[1], o.shape[1]
    if El == 0:
        return o.new_zeros(e_flat.shape + o.shape[-1:])
    g_ix = torch.arange(o.shape[0], device=o.device)[:, None]
    e = e_flat - e0
    got = o[g_ix, e.clamp(0, El - 1), pos.clamp_max(C - 1)]
    if El == E:
        return got
    return torch.where(((e >= 0) & (e < El))[..., None], got, 0)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), the Switch load-balance aux loss, a 0-d
    fp32 tensor; serving drops it)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = cfg.moe_groups if T % max(cfg.moe_groups, 1) == 0 else 1
    Tl = T // G
    C = expert_capacity(Tl, cfg)
    xt = flatten(x, 0, 1)                            # (T, D)
    logits = xt.float() @ p["router"]                # (T, E) fp32
    w, idx = route_topk(logits, K)                   # (T, K)

    # group-local dispatch: capacity is enforced per group; in the dry run
    # each rank scatters the groups it holds into its own experts' queues,
    # as GSPMD does (DTensor has no index_put rule in every torch release)
    xg = shard(xt.reshape(G, Tl, D), "batch", None, None)
    experts = shard(full((G, E), 0, x.dtype, x.device, "batch", "experts"),
                    "batch", "experts")
    buf, e_flat, pos = per_shard(
        _dispatch, experts, xg, unflatten(idx, 0, (G, Tl)), dims=(0, 1),
        shape=((G, E, C, D), (G, Tl * K), (G, Tl * K)),
        arg_dims=((0, None),) * 2, out_dims=((0, 1), (0, None), (0, None)),
        offsets=True, E=E, C=C)
    buf = shard(buf, "batch", "experts", None, None)

    # expert GEMMs, one batched product each
    h = shard(torch.einsum("gecd,edf->gecf", buf, p["moe_wi"]),
              "batch", "experts", None, None)
    h = swiglu(h)
    o = shard(torch.einsum("gecf,efd->gecd", h, p["moe_wdown"]),
              "batch", "experts", None, None)

    # combine: gather each choice's expert output, weight, sum over K; in
    # the dry run each rank reads its own experts' rows and one all-reduce
    # sums the shares, as GSPMD does
    gathered = shard(per_shard(
        _gather, o, e_flat, pos, dims=(0, 1), shape=(G, Tl * K, D),
        arg_dims=((0, None),) * 2, out_dims=(0, "sum"), offsets=True, E=E,
        C=C), "batch", None, None)                       # (G, TlK, D)
    keep = (pos < C).float()[..., None]
    wk = unflatten(w, 0, (G, Tl)).reshape(G, Tl * K)[..., None] * keep
    v = (gathered.float() * wk).reshape(G, Tl, K, D)
    out = v[:, :, 0]
    for k in range(1, K):                            # JAX's scatter order
        out = out + v[:, :, k]
    # its gradient too whole over the sequence before the view's backward
    # merges (B, S) (torch 2.11 refuses a cut S there)
    out = shard(out.reshape(B, S, D), "batch", None, "embed").to(x.dtype)

    # Switch-style load-balance aux loss
    gates = torch.softmax(logits, dim=-1)
    density = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * (density * gates.mean(dim=0)).sum()

    if cfg.moe_dense_residual:
        out = out + mlp_forward(p, x)
    return out, aux
