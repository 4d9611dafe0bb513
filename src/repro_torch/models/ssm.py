"""Sequence state-space blocks: Mamba2 (chunked SSD) and xLSTM (m/sLSTM).

A copy of the JAX package's ``models/ssm.py`` in plain PyTorch. The
Mamba2 and mLSTM scans stream the sequence in chunks: the inter-chunk
state is carried, the work within a chunk is dense products, and the
(S x S) interaction is never built. The sLSTM is a true recurrence, a
Python loop over the tokens as JAX's ``lax.scan`` is a loop.

All recurrences run in fp32 whatever the activation dtype. Where a
chunk's decay or log-weight could be ``inf`` or ``-inf`` above the
diagonal, its argument is masked with ``torch.where`` before the
``exp``, never the result by a product with the mask, which would turn
``inf * 0`` into NaN in the forward or the backward.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, swiglu
from repro_torch.parallel.sharding import (chunk, flatten, full,
                                           group_gather, group_sum, matmul,
                                           parts_group, per_shard, pieces,
                                           shard, unflatten)

Params = Dict[str, torch.Tensor]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's softplus turns
    into the identity past a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -_softplus(-x)


def _causal_mask(Q: int, device) -> torch.Tensor:
    return torch.ones((Q, Q), dtype=torch.bool, device=device).tril()


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_d_inner
    nh = cfg.ssm_heads
    P = cfg.ssm_headdim
    N = cfg.ssm_state
    assert nh * P == d_inner
    return d_inner, nh, P, N


def init_mamba_params(cfg: ModelConfig, dtype: torch.dtype,
                      generator: torch.Generator, device=None) -> Params:
    device = generator.device if device is None else torch.device(device)
    d = cfg.d_model
    d_inner, nh, P, N = mamba_dims(cfg)
    conv_dim = d_inner + 2 * N
    W = cfg.ssm_conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init((d, 2 * d_inner + 2 * N + nh), dtype,
                              generator, device),
        "conv_w": dense_init((W, conv_dim), dtype, generator, device,
                             scale=math.sqrt(W)),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, float(nh), nh, **f32)),
        "D": torch.ones(nh, **f32),
        "dt_bias": torch.full((nh,), math.log(math.expm1(0.01)), **f32),
        "ssm_norm": torch.ones(d_inner, dtype=dtype, device=device),
        "out_proj": dense_init((d_inner, d), dtype, generator, device),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along seq. x (B,S,C); w (W,C); state (B,W-1,C).

    Returns (y, new_state). With ``state`` given, x may be S=1 (decode).
    """
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+W-1, C)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):, :]
    return F.silu(y + b), new_state


class MambaState(NamedTuple):
    ssm: torch.Tensor                                # (B, nh, P, N) fp32
    conv: torch.Tensor                               # (B, W-1, conv_dim)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device, n_layers: Optional[int] = None) -> MambaState:
    """Zeroed state; with ``n_layers``, stacked with a leading layer axis."""
    d_inner, nh, P, N = mamba_dims(cfg)
    lead = (n_layers,) if n_layers else ()
    return MambaState(
        torch.zeros(lead + (batch, nh, P, N), dtype=torch.float32,
                    device=device),
        torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, d_inner + 2 * N),
                    dtype=dtype, device=device))


def _split_in_proj(h: torch.Tensor, cfg: ModelConfig):
    d_inner, nh, P, N = mamba_dims(cfg)
    return torch.split(h, [d_inner, d_inner + 2 * N, nh], dim=-1)


def mamba_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[MambaState] = None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence chunked SSD. x (B,S,D) -> (y (B,S,D), final state).

    Arbitrary S: a remainder chunk (S % ssm_chunk) is processed as a second
    pass carrying the state, exactly as the JAX module does.
    """
    Bsz, S, _ = x.shape
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        s0 = (S // Q) * Q
        y0, state = mamba_forward(p, x[:, :s0], cfg, state)
        y1, state = mamba_forward(p, x[:, s0:], cfg, state)
        return torch.cat([y0, y1], dim=1), state
    d_inner, nh, P, N = mamba_dims(cfg)

    h = matmul(x, p["in_proj"])
    z, xbc, dt_pre = _split_in_proj(h, cfg)
    if state is None:
        state = init_mamba_state(cfg, Bsz, x.dtype, x.device)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                    state.conv)
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = _softplus(dt_pre.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                     # (nh,)
    # the heads cut over "model", as GSPMD carries the in-projection's cut
    # into the scan (the port names the cut JAX leaves to propagation)
    xh = shard(xs.reshape(Bsz, S, nh, P).float(), "batch", "seq", "heads",
               None)
    Bm = Bmat.float()                                              # (B,S,N)
    Cm = Cmat.float()

    # --- chunked SSD scan: carry the (B, nh, P, N) state across chunks,
    # each rank its own heads (B and C are shared by all heads) ---
    y, st = per_shard(_ssd_scan, xh, Bm, Cm, dt, state.ssm, A, dims=(0, 2),
                      shape=(xh.shape, state.ssm.shape),
                      arg_dims=((0, None), (0, None), (0, 2), (0, 1),
                                (None, 0)),
                      out_dims=((0, 2), (0, 1)), Q=Q)
    y = y + xh * p["D"][None, None, :, None]         # skip connection
    y = flatten(y, 2, 3).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return matmul(y, p["out_proj"]), MambaState(st, conv_state)


def _ssd_scan(xh, Bm, Cm, dt, st, A, Q: int):
    """The chunked SSD scan over (B, S, nh, P) inputs -> (y, final state)."""
    Bsz, S, nh, P = xh.shape
    N = Bm.shape[-1]
    NC = S // Q
    xc = xh.reshape(Bsz, NC, Q, nh, P)
    Bc = Bm.reshape(Bsz, NC, Q, N)
    Cc = Cm.reshape(Bsz, NC, Q, N)
    dtc = dt.reshape(Bsz, NC, Q, nh)
    mask = _causal_mask(Q, xh.device)[None, :, :, None]
    ys = []
    for c in range(NC):
        xq, bq, cq, dq = xc[:, c], Bc[:, c], Cc[:, c], dtc[:, c]
        dta = dq * A                                 # (B,Q,nh) log-decay
        s_in = torch.cumsum(dta, dim=1)              # inclusive cumsum
        # inter-chunk: y_i += C_i . (state * exp(s_i))
        y_inter = torch.einsum("bqn,bhpn,bqh->bqhp", cq, st, torch.exp(s_in))
        # intra-chunk: decay(i,j) = exp(s_i - s_j), i >= j, else 0. Above
        # the diagonal the argument is positive and overflows at full
        # width (up to 137 in a 128-token chunk of zamba2-1.2b at init):
        # masked after the exp, as JAX does, exp's backward would multiply
        # the zero gradient there by inf (NaN). Masking the argument first
        # gives the same forward values and a finite backward.
        seg = s_in[:, :, None, :] - s_in[:, None, :, :]
        dec = torch.exp(torch.where(mask, seg, -math.inf))         # (B,Q,Q,h)
        cb = torch.einsum("bqn,bjn->bqj", cq, bq)                  # (B,Q,Q)
        w_ij = cb[:, :, :, None] * dec * dq[:, None, :, :]
        y_intra = torch.einsum("bqjh,bjhp->bqhp", w_ij, xq)
        # state update: st' = st*exp(s_Q) + sum_j exp(s_Q - s_j) dt_j x_j B_j^T
        tail = torch.exp(s_in[:, -1:, :] - s_in)                   # (B,Q,h)
        st = st * torch.exp(s_in[:, -1, :])[:, :, None, None] + torch.einsum(
            "bqh,bqhp,bqn->bhpn", tail * dq, xq, bq)
        ys.append(y_inter + y_intra)
    return torch.stack(ys, dim=1).reshape(Bsz, S, nh, P), st


def mamba_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """Single-token recurrent step. x (B,1,D)."""
    Bsz = x.shape[0]
    d_inner, nh, P, N = mamba_dims(cfg)
    h = matmul(x, p["in_proj"])
    z, xbc, dt_pre = _split_in_proj(h, cfg)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                    state.conv)
    xs, Bm, Cm = torch.split(xbc[:, 0], [d_inner, N, N], dim=-1)

    dt = _softplus(dt_pre[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, nh, P).float()
    decay = torch.exp(dt * A)                        # (B,nh)
    st = state.ssm * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bm.float())
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), st)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return matmul(y, p["out_proj"]), MambaState(st, conv_state)


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory w/ recurrence)
# ===========================================================================

def xlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    nh = cfg.n_heads
    d_inner = cfg.d_model                             # no expansion
    return d_inner, nh, d_inner // nh


def init_mlstm_params(cfg: ModelConfig, dtype: torch.dtype,
                      generator: torch.Generator, device=None) -> Params:
    device = generator.device if device is None else torch.device(device)
    d = cfg.d_model
    d_inner, nh, P = xlstm_dims(cfg)
    return {
        "w_up": dense_init((d, 2 * d_inner), dtype, generator, device),
        "wqkv": dense_init((d_inner, 3 * d_inner), dtype, generator, device),
        "w_gates": dense_init((d_inner, 2 * nh), dtype, generator, device),
        "gate_b": torch.cat([                                   # i, f
            torch.zeros(nh, device=device),
            torch.linspace(3.0, 6.0, nh, device=device)]).float(),
        "mem_norm": torch.ones(d_inner, dtype=dtype, device=device),
        "wdown": dense_init((d_inner, d), dtype, generator, device),
    }


class MLSTMState(NamedTuple):
    C: torch.Tensor                                  # (B, nh, P, P)
    n: torch.Tensor                                  # (B, nh, P)
    m: torch.Tensor                                  # (B, nh)


def init_mlstm_state(cfg: ModelConfig, batch: int, device,
                     n_layers: Optional[int] = None) -> MLSTMState:
    _, nh, P = xlstm_dims(cfg)
    lead = (n_layers,) if n_layers else ()
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(torch.zeros(lead + (batch, nh, P, P), **f32),
                      torch.zeros(lead + (batch, nh, P), **f32),
                      torch.full(lead + (batch, nh), -1e30, **f32))


def _mlstm_step(state: MLSTMState, q, k, v, i_pre, f_pre):
    """Stabilized exponential-gating mLSTM cell. All (B,nh,...) fp32."""
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state.m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + state.m - m_new)
    C = state.C * f_g[..., None, None] + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = state.n * f_g[..., None] + i_g[..., None] * k
    denom = torch.maximum(torch.einsum("bhp,bhp->bh", n, q).abs(),
                          torch.exp(-m_new))
    y = torch.einsum("bhpq,bhq->bhp", C, q) / denom[..., None]
    return MLSTMState(C, n, m_new), y


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[MLSTMState] = None
                  ) -> Tuple[torch.Tensor, MLSTMState]:
    """Chunkwise-parallel stabilized mLSTM, as the JAX module computes it.

    Intra-chunk interactions are a masked product, and the (P x P)
    matrix memory crosses chunk boundaries as the carried state. It
    matches :func:`_mlstm_step` step by step (tested)."""
    Bsz, S, _ = x.shape
    _, nh, P = xlstm_dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    if S % Q:                        # remainder chunk, state carried exactly
        s0 = (S // Q) * Q
        y0, state = mlstm_forward(p, x[:, :s0], cfg, state)
        y1, state = mlstm_forward(p, x[:, s0:], cfg, state)
        return torch.cat([y0, y1], dim=1), state
    xin, z = chunk(matmul(x, p["w_up"]), 2, -1)
    qkv = unflatten(matmul(xin, p["wqkv"]), 2, (3, nh, P)).float()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1] / math.sqrt(P), qkv[:, :, 2]
    gates = matmul(xin, p["w_gates"]).float() + p["gate_b"]
    gates = unflatten(gates, 2, (2, nh))
    i_pre, f_pre = gates[:, :, 0], gates[:, :, 1]          # (B,S,nh)

    if state is None:
        state = init_mlstm_state(cfg, Bsz, x.device)
    shapes = (q.shape,) + tuple(a.shape for a in state)
    parts = pieces(q, nh, "heads")
    if parts > 1 and P % parts == 0:
        # fewer heads than the "heads" rule's ranks: each rank its piece of
        # the flattened (head, P), as GSPMD cuts it (xlstm-125m's 4 heads
        # on TP 16: 1 head x 48 of 192 a rank), from whole q, k, v and
        # states; ``piece`` carries the cut (B, nh * P)
        piece = full((Bsz, nh * P), 0, torch.float32, x.device, "batch",
                     "heads")
        group, mesh_dim = parts_group(piece, 1, parts)
        y, *st = per_shard(
            _mlstm_parts, piece, q, k, v, i_pre, f_pre, *state,
            dims=(0, 1), shape=((Bsz, S, nh * P),) + shapes[1:],
            arg_dims=((0, None),) * 8, out_dims=((0, 2),) + ((0, None),) * 3,
            offsets=True, P=P, Q=Q, group=group, mesh_dim=mesh_dim)
        y = y.to(x.dtype)
    else:
        # each rank its own heads (ceil chunks: xlstm's 4 on TP 8 fall on
        # the first 4 ranks)
        q = shard(q, "batch", "seq", "heads", None)
        y, *st = per_shard(_mlstm_scan, q, k, v, i_pre, f_pre, *state,
                           dims=(0, 2), shape=shapes,
                           arg_dims=((0, 2),) * 4 + ((0, 1),) * 3,
                           out_dims=((0, 2),) + ((0, 1),) * 3, Q=Q)
        y = flatten(y, 2, 3).to(x.dtype)
    y = rms_norm(y, p["mem_norm"], cfg.norm_eps) * F.silu(z)
    return matmul(y, p["wdown"]), MLSTMState(*st)


def _mlstm_parts(piece, q, k, v, i_pre, f_pre, C, n, m, offsets, P: int,
                 Q: int, group, mesh_dim):
    """A rank's piece of the mLSTM: the ``piece.shape[1]`` columns of the
    flattened (head, P) from ``offsets[1]``, of whole q, k, v (B, S, nh,
    P), gates and states. The scan sums q.k over the ``group`` that
    shares the head and gathers q and k there for the state's terms; the
    final states are gathered whole over ``mesh_dim`` -> (y (B, S, pl),
    C, n, m)."""
    h, p0 = divmod(offsets[1], P)
    part = slice(p0, p0 + piece.shape[1])
    y, Cl, nl, ml = _mlstm_scan(
        q[:, :, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1, part],
        i_pre[:, :, h:h + 1], f_pre[:, :, h:h + 1], C[:, h:h + 1, :, part],
        n[:, h:h + 1], m[:, h:h + 1], Q=Q, group=group, part=part)
    ranks = P // piece.shape[1]                  # ranks a head
    nh = C.shape[1]
    # every rank's piece, in rank order: rank r holds head r // ranks, the
    # columns (r % ranks) * pl of its C, and its head's whole n and m
    Cg = group_gather(Cl[None], 0, mesh_dim)     # (nh ranks, B, 1, P, pl)
    Cg = Cg.reshape(nh, ranks, *Cl.shape).permute(2, 0, 4, 1, 3, 5)
    ng, mg = (group_gather(a[None], 0, mesh_dim)[::ranks, :, 0].movedim(0, 1)
              for a in (nl, ml))
    return y[:, :, 0], Cg.reshape(C.shape), ng, mg


def _mlstm_scan(q, k, v, i_pre, f_pre, C, n, m, Q: int, group=None,
                part=None):
    """The chunkwise mLSTM over (B, S, nh, P) inputs from the state
    (C, n, m) -> (y (B, S, nh, P), C, n, m). With a ``group`` of ranks
    that share the heads, v, C and y are this rank's ``part`` of P (C's
    columns), and each q.k is this part's partial sum, summed over the
    group."""
    Bsz, S = q.shape[:2]
    NC = S // Q

    def ch(a):                                             # (B, NC, Q, ...)
        return a.reshape(Bsz, NC, Q, *a.shape[2:])
    qc, kc, vc, ic, fc = map(ch, (q, k, v, i_pre, f_pre))
    part = slice(None) if part is None else part
    mask = _causal_mask(Q, q.device)[None, :, :, None]
    st = MLSTMState(C, n, m)
    ys = []
    for c in range(NC):
        qj, kj, vj, ij, fj = qc[:, c], kc[:, c], vc[:, c], ic[:, c], fc[:, c]
        log_f = _log_sigmoid(fj)                           # (B,Q,nh)
        b = torch.cumsum(log_f, dim=1)                     # inclusive
        btot = b[:, -1]                                    # (B,nh)
        # D_ij = (b_i - b_j) + i_j for j <= i (decay j+1..i, input i_j)
        D = b[:, :, None, :] - b[:, None, :, :] + ij[:, None, :, :]
        D = torch.where(mask, D, -math.inf)
        m_intra = D.amax(dim=2)                            # (B,Q,nh)
        m_inter = st.m[:, None, :] + b                     # (B,Q,nh)
        m_i = torch.clamp_min(torch.maximum(m_intra, m_inter), -1e30)
        Sij = group_sum(torch.einsum("bihp,bjhp->bijh", qj[..., part],
                                     kj[..., part]), group) * torch.exp(
            D - m_i[:, :, None, :])
        inter_scale = torch.exp(m_inter - m_i)             # (B,Q,nh)
        num = torch.einsum("bijh,bjhp->bihp", Sij, vj) + \
            inter_scale[..., None] * torch.einsum("bihp,bhpq->bihq", qj, st.C)
        den = Sij.sum(dim=2) + inter_scale * torch.einsum(
            "bihp,bhp->bih", qj, st.n)
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # state update across the chunk boundary
        g = btot[:, None, :] - b + ij                      # (B,Q,nh)
        m_new = torch.maximum(st.m + btot, g.amax(dim=1))
        w_st = torch.exp(g - m_new[:, None, :])
        carry = torch.exp(st.m + btot - m_new)
        C = st.C * carry[..., None, None] + \
            torch.einsum("bjh,bjhp,bjhq->bhpq", w_st, kj, vj)
        n = st.n * carry[..., None] + torch.einsum("bjh,bjhp->bhp", w_st, kj)
        st = MLSTMState(C, n, m_new)
    return (torch.stack(ys, dim=1).reshape(v.shape), *st)


def mlstm_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: MLSTMState) -> Tuple[torch.Tensor, MLSTMState]:
    return mlstm_forward(p, x, cfg, state)


def init_slstm_params(cfg: ModelConfig, dtype: torch.dtype,
                      generator: torch.Generator, device=None) -> Params:
    device = generator.device if device is None else torch.device(device)
    d = cfg.d_model
    d_inner, nh, P = xlstm_dims(cfg)
    pf = max(8, int(d * 4 / 3) // 8 * 8)             # xLSTM's 4/3 proj factor
    return {
        "w_gates": dense_init((d, 4 * d_inner), dtype, generator, device),
        "r_gates": dense_init((nh, P, 4 * P), torch.float32, generator,
                              device),
        "gate_b": torch.zeros(4 * d_inner, dtype=torch.float32,
                              device=device),
        "mem_norm": torch.ones(d_inner, dtype=dtype, device=device),
        "w_up": dense_init((d_inner, 2 * pf), dtype, generator, device),
        "wdown": dense_init((pf, d), dtype, generator, device),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor                                  # (B, nh, P)
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def init_slstm_state(cfg: ModelConfig, batch: int, device,
                     n_layers: Optional[int] = None) -> SLSTMState:
    _, nh, P = xlstm_dims(cfg)
    shape = ((n_layers,) if n_layers else ()) + (batch, nh, P)
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(torch.zeros(shape, **f32), torch.zeros(shape, **f32),
                      torch.full(shape, -1e30, **f32),
                      torch.zeros(shape, **f32))


def _slstm_step(p: Params, state: SLSTMState, gx: torch.Tensor
                ) -> SLSTMState:
    """gx: (B, nh, 4P) input-gate preactivations for one step (fp32)."""
    rec = torch.einsum("bhp,hpq->bhq", state.h, p["r_gates"])
    pre = gx + rec                                   # (B, nh, 4P)
    zt, it, ft, ot = pre.chunk(4, dim=-1)
    log_f = _log_sigmoid(ft)
    m_new = torch.maximum(log_f + state.m, it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(log_f + state.m - m_new)
    c = f_g * state.c + i_g * torch.tanh(zt)
    n = f_g * state.n + i_g
    h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
    return SLSTMState(c, n, m_new, h)


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[SLSTMState] = None
                  ) -> Tuple[torch.Tensor, SLSTMState]:
    """The sLSTM recurrence, one step a token (S steps, as JAX's scan)."""
    Bsz, S, _ = x.shape
    d_inner, nh, P = xlstm_dims(cfg)
    gx = matmul(x, p["w_gates"]).float() + p["gate_b"]
    # (B,S,4*d_inner) -> (B,S,nh,4P): per-head gate grouping
    gx = unflatten(gx, 2, (4, nh, P)).permute(0, 1, 3, 2, 4)
    gx = gx.reshape(Bsz, S, nh, 4 * P)
    if state is None:
        state = init_slstm_state(cfg, Bsz, x.device)
    hs = []
    for t in range(S):
        state = _slstm_step(p, state, gx[:, t])
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(Bsz, S, d_inner).to(x.dtype)
    h = rms_norm(h, p["mem_norm"], cfg.norm_eps)
    return matmul(swiglu(matmul(h, p["w_up"])), p["wdown"]), state


def slstm_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: SLSTMState) -> Tuple[torch.Tensor, SLSTMState]:
    return slstm_forward(p, x, cfg, state)
