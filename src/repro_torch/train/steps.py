"""Step functions: the serving half of the JAX package's ``train/steps.py``
(``serve_prefill`` and ``serve_decode``). ``init_train_state`` and
``train_step`` come with the training slice (ROADMAP.md Queue 1, 8b)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.models import lm


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Argmax over the real vocab: the padded columns get -1e30 added, in
    the logits' dtype (JAX's weakly typed mask keeps bf16 logits bf16).
    Ties take the first maximum, as in JAX."""
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    mask = torch.where(pad, -1e30, 0.0).to(logits.dtype)
    return torch.argmax(logits + mask, dim=-1)


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
