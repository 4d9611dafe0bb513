"""Deterministic synthetic data pipelines (tokens + images): a copy of the
JAX package's ``data/pipeline.py``, numpy only, so both packages draw the
same bytes for the same seed, step and host.

Deterministic per (seed, step, host): every host materializes only its own
shard of the global batch — the data-parallel loading pattern of a real
multi-host deployment — and restarts reproduce the exact stream, which the
fault-tolerance test relies on (loss continuity across restore).

The token stream is a fixed-transition Markov chain rather than iid noise
so the LM loss has learnable structure (training-progress tests assert the
loss actually falls).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _markov_tokens(rng: np.random.Generator, batch: int, seq: int,
                   vocab: int) -> np.ndarray:
    """Markov stream: token_{t+1} = (a*token_t + noise) % vocab."""
    a = 31
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    noise = (rng.random((batch, seq)) < 0.1)
    jump = rng.integers(0, vocab, (batch, seq))
    for t in range(seq):
        nxt = (toks[:, t] * a + 7) % vocab
        toks[:, t + 1] = np.where(noise[:, t], jump[:, t], nxt)
    return toks


def token_batches(cfg: DataConfig, model_cfg: Optional[ModelConfig] = None,
                  start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yield host-local batches {tokens, labels[, frontend_embed]}."""
    per_host = cfg.global_batch // cfg.n_hosts
    step = start_step
    while True:
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4099 + cfg.host_id)
        toks = _markov_tokens(rng, per_host, cfg.seq_len, cfg.vocab)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if model_cfg is not None and model_cfg.frontend:
            batch["frontend_embed"] = rng.standard_normal(
                (per_host, model_cfg.frontend_len, model_cfg.d_model)
            ).astype(np.float32) * 0.02
        yield batch
        step += 1


def image_batches(batch: int, hw: int, ch: int, n_classes: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic image stream for the CNN reproduction benchmarks."""
    step = 0
    while True:
        rng = np.random.default_rng(seed * 7919 + step)
        x = rng.standard_normal((batch, hw, hw, ch)).astype(np.float32)
        y = rng.integers(0, n_classes, batch).astype(np.int32)
        yield {"images": x, "labels": y}
        step += 1
