"""Step functions: a copy of the JAX package's ``train/steps.py``.

``train_step`` is JAX's ``value_and_grad`` of ``lm.loss_fn`` as autograd
(``torch.autograd.grad`` over the parameter leaves) followed by
``adamw_update``; ``serve_prefill`` and ``serve_decode`` are the serving
half. As the JAX loop donates the state to its jitted step, the step
updates the parameters and the optimizer moments in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import lm
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_update,
                                     init_adamw)
from repro_torch.parallel.sharding import shard
from repro_torch.pipeline.compile import resolve_device


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _ocfg(cfg: ModelConfig, ocfg: Optional[AdamWConfig]) -> AdamWConfig:
    return ocfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     ocfg: Optional[AdamWConfig] = None,
                     device=None) -> TrainState:
    """Random parameters from ``generator`` (as :func:`lm.init_params`
    draws them) and zeroed AdamW state, on ``device`` (the CUDA device by
    default, which raises when there is none)."""
    params = lm.init_params(cfg, generator, resolve_device(device))
    return TrainState(params, init_adamw(params, _ocfg(cfg, ocfg)))


def train_state_from_jax(state, device) -> TrainState:
    """The JAX package's ``TrainState`` (params, ``AdamWState(step, m,
    v)``; numpy arrays or anything ``np.asarray`` takes) as the port's, on
    ``device``, in the same dtypes."""
    opt = state.opt
    return TrainState(
        lm.params_from_jax(state.params, device),
        AdamWState(lm.params_from_jax(opt.step, device).to(torch.int32),
                   lm.params_from_jax(opt.m, device),
                   lm.params_from_jax(opt.v, device)))


def loss_and_grads(params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Any]:
    """``jax.value_and_grad(lm.loss_fn)``: the loss (detached) and the
    gradient tree, in the parameters' dtypes. The parameters themselves
    are left as they are (their aliases take the gradient)."""
    with torch.enable_grad():
        live = lm.tree_map(lambda a: a.detach().requires_grad_(), params)
        leaves = [a for _, a in lm.tree_leaves(live)]
        loss = lm.loss_fn(live, batch, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), lm.tree_map(lambda _: next(grads), params)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, ocfg: Optional[AdamWConfig] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One step. ``state``'s parameters and moments are updated in place
    and returned in the new state (JAX's loop donates them)."""
    loss, grads = loss_and_grads(state.params, batch, cfg)
    new_params, new_opt, metrics = adamw_update(
        grads, state.opt, state.params, _ocfg(cfg, ocfg))
    return TrainState(new_params, new_opt), dict(metrics, loss=loss)


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Argmax over the real vocab (``lm.pad_mask`` added, in the logits'
    dtype). Ties take the first maximum, as in JAX. A vocab-sharded row
    (the dry run) is gathered first: DTensor has no argmax over a cut
    dim."""
    logits = shard(logits, "batch", "seq", None)
    return torch.argmax(logits + lm.pad_mask(logits, cfg), dim=-1)


def serve_prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  s_max: int):
    """Prefill a prompt batch -> (next-token ids, logits, cache)."""
    logits, cache = lm.prefill(params, batch["tokens"], cfg, s_max,
                               batch.get("frontend_embed"))
    return _greedy(logits, cfg), logits, cache


def serve_decode(params, tokens: torch.Tensor, cache: lm.DecodeCache,
                 cfg: ModelConfig):
    """One decode step -> (next-token ids, logits, new cache)."""
    logits, cache = lm.decode_step(params, tokens, cache, cfg)
    return _greedy(logits, cfg), logits, cache
