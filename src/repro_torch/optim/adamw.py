"""AdamW: a copy of the JAX package's ``optim/adamw.py``.

The state dtype is configurable (``ModelConfig.opt_state_dtype``): fp32
by default, bf16 for arctic-480b. The step is an int32 tensor on the
parameters' device and every schedule scalar is computed there in fp32,
so no step waits on the host. As the JAX loop donates the state to its
jitted step, :func:`adamw_update` writes the new parameters and moments
into the tensors it was given and returns them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.lm import tree_leaves, tree_map

# a leaf is updated in slices of its leading axis of at most this many
# elements, so the fp32 temporaries of one update stay small (a stacked
# Qwen3-8B FFN leaf of 8 layers is 805 M elements); the arithmetic is
# elementwise, so the slices give the values the whole leaf would
_SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor         # 0-d int32 on the parameters' device
    m: Any                     # tree like params
    v: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp32, filled in on ``like``'s device. A divisor
    must be a tensor: on a CUDA tensor, ``t / python_float`` is computed
    as ``t * (1 / x)``, an ulp off the quotient JAX computes."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def init_adamw(params, cfg: AdamWConfig) -> AdamWState:
    dt = dtype_of(cfg.state_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = next(tree_leaves(params))[1].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def lr_schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup -> cosine decay (a 0-d fp32 tensor). Every scalar is
    an fp32 tensor, ``pi * t`` and its cosine too, as in JAX: computed in
    Python's float64 they land an ulp away."""
    step = step.float()
    f = lambda x: _f32(x, step)
    warm = f(cfg.lr) * step / f(max(cfg.warmup_steps, 1))
    t = torch.clamp((step - f(cfg.warmup_steps))
                    / f(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = f(0.5 * cfg.lr) * (1.0 + torch.cos(f(math.pi) * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return torch.stack([l.float().square().sum()
                        for _, l in tree_leaves(tree)]).sum().sqrt()


def _slices(t: torch.Tensor):
    """``t`` in views along its leading axis of at most ``_SLICE``
    elements (the whole tensor where it is smaller or 0- or 1-d)."""
    if t.dim() < 2 or t.numel() <= _SLICE:
        return (t,)
    rows = max(1, _SLICE // (t.numel() // t.shape[0]))
    return t.split(rows)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params,
                 cfg: AdamWConfig) -> Tuple[Any, AdamWState, Dict[str, Any]]:
    """Returns (new_params, new_state, metrics); the new parameters and
    moments are ``params``'s and ``state``'s tensors, written in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(_f32(cfg.grad_clip, gnorm)
                            / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    stepf = step.float()
    b1, b2 = cfg.b1, cfg.b2
    # fp32 powers of the fp32 step, as in JAX (not Python's float64)
    bc1 = 1.0 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_f32(b2, stepf), stepf)
    sdt = dtype_of(cfg.state_dtype)

    def upd(p, g, m, v):
        # decoupled weight decay on every leaf of two or more dimensions,
        # as JAX's ``p.ndim >= 2``: on the stacked tree that includes each
        # layer's gains and Mamba vectors (ln1, ln2, A_log, dt_bias, D:
        # (L, d)), and not final_norm (d,). Kept as the reference has it.
        decay = p.dim() >= 2
        for ps, gs, ms, vs in zip(*map(_slices, (p, g, m, v))):
            g32 = gs.float() * scale
            m32 = ms.float() * b1 + (1 - b1) * g32
            v32 = vs.float() * b2 + (1 - b2) * torch.square(g32)
            update = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if decay:
                update = update + cfg.weight_decay * ps.float()
            ps.copy_(ps.float() - lr * update)
            ms.copy_(m32.to(sdt))
            vs.copy_(v32.to(sdt))
        return p

    new_params = tree_map(upd, params, grads, state.m, state.v)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, AdamWState(step, state.m, state.v), metrics
