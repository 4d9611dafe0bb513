"""Resilient training loop: a copy of the JAX package's ``train/loop.py``.

* checkpoint every ``ckpt_every`` steps, asynchronously (the state is
  copied to the host, then written on a thread);
* on ANY step failure (device loss or preemption, simulated through an
  injected fault), restore the latest committed checkpoint, rebuild the
  data stream at the restored step, and continue, up to ``max_restarts``;
* a per-step wall-clock watchdog: steps slower than ``straggler_factor``
  x the median of the last 50 are logged and counted;
* optional int8 error-feedback gradient compression.

The step runs eagerly where JAX jits it. Unlike the JAX loop, whose jitted
step bakes in the zero residual it held when traced, the compressed step
carries the compression residual from step to step, as
``optim/compress.py`` says it does. A restart restores on the same device:
nothing moves to the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         load_checkpoint)
from repro_torch.core.config import ModelConfig
from repro_torch.data.pipeline import DataConfig, token_batches
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compress import compress_grads, init_compression
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.steps import (TrainState, init_train_state,
                                     loss_and_grads, train_step)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    # None: no checkpoints (no restore, no saves; a restart begins again
    # from the seed)
    ckpt_dir: Optional[str] = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    keep: int = 2
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    compress_grads: bool = False


class ResilientLoop:
    def __init__(self, cfg: ModelConfig, loop_cfg: LoopConfig,
                 data_cfg: DataConfig, ocfg: Optional[AdamWConfig] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device=None):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.data_cfg = data_cfg
        self.ocfg = ocfg or AdamWConfig(state_dtype=cfg.opt_state_dtype)
        self.fault_hook = fault_hook or (lambda step: None)
        self.device = resolve_device(device)
        self.manager = (None if loop_cfg.ckpt_dir is None else
                        CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.keep))
        self.metrics_log: list = []
        self.straggler_events: list = []
        self.restarts = 0
        self._step = (self._compressed_step if loop_cfg.compress_grads
                      else lambda state, batch: train_step(
                          state, batch, cfg, self.ocfg))

    def _compressed_step(self, state: TrainState, batch):
        loss, grads = loss_and_grads(state.params, batch, self.cfg)
        grads, self._comp_state = compress_grads(grads, self._comp_state)
        newp, newo, metrics = adamw_update(grads, state.opt, state.params,
                                           self.ocfg)
        return TrainState(newp, newo), dict(metrics, loss=loss)

    def _init_state(self) -> tuple:
        g = torch.Generator(self.device).manual_seed(self.data_cfg.seed)
        state = init_train_state(self.cfg, g, self.ocfg, self.device)
        if self.loop_cfg.compress_grads:
            self._comp_state = init_compression(state.params)
        start = 0
        ckpt_dir = self.loop_cfg.ckpt_dir
        if ckpt_dir is not None and latest_step(ckpt_dir) is not None:
            state, start = load_checkpoint(ckpt_dir, state)
            print(f"[loop] restored checkpoint at step {start}")
        return state, start

    def _save(self, step: int, state: TrainState) -> None:
        if self.manager is not None:
            self.manager.save_async(step, state)

    def _wait(self) -> None:
        if self.manager is not None:
            self.manager.wait()

    def _batches(self, step: int):
        for batch in token_batches(self.data_cfg, self.cfg, start_step=step):
            yield {k: torch.from_numpy(v).to(self.device)
                   for k, v in batch.items()}

    def run(self) -> Dict[str, Any]:
        state, step = self._init_state()
        data = self._batches(step)
        durations: list = []
        while step < self.loop_cfg.total_steps:
            try:
                batch = next(data)
                self.fault_hook(step)               # test injection point
                # repro: allow[RPA102] step timing drives straggler detection
                t0 = time.time()
                state, metrics = self._step(state, batch)
                loss = float(metrics["loss"])
                # repro: allow[RPA102] step timing drives straggler detection
                dt = time.time() - t0
                durations.append(dt)
                med = float(np.median(durations[-50:]))
                if (len(durations) > 5
                        and dt > self.loop_cfg.straggler_factor * med):
                    self.straggler_events.append((step, dt, med))
                    print(f"[loop] straggler at step {step}: "
                          f"{dt:.2f}s vs median {med:.2f}s")
                step += 1
                self.metrics_log.append({"step": step, "loss": loss})
                if step % self.loop_cfg.log_every == 0:
                    print(f"[loop] step {step} loss {loss:.4f} ({dt:.2f}s)")
                if step % self.loop_cfg.ckpt_every == 0:
                    self._save(step, state)
            except KeyboardInterrupt:
                raise
            except Exception as e:
                self.restarts += 1
                print(f"[loop] step {step} FAILED ({type(e).__name__}: {e});"
                      f" restart {self.restarts}/{self.loop_cfg.max_restarts}")
                if self.restarts > self.loop_cfg.max_restarts:
                    raise
                self._wait()
                state = None                # free it before the restore
                state, step = self._init_state()
                data = self._batches(step)
        self._wait()
        self._save(step, state)
        self._wait()
        return {"final_step": step, "restarts": self.restarts,
                "stragglers": len(self.straggler_events),
                "metrics": self.metrics_log}
