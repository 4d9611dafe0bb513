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
``optim/compress.py`` says it does. Each checkpoint of a compressed run
also commits the residual the next step consumes, in a directory of its
own (``<ckpt_dir>/residual/step_<N>/``, pruned with the state's), so the
state's ``step_<N>/`` files stay JAX's and a restart resumes the run it
interrupted. The residual is committed before the state, on the same
thread, so a process killed between the two leaves no state without its
residual; a restore takes the newest step that has both, and carries
zeros, as JAX's loop does, only where no residual was ever written. A
restart restores on the same device: nothing moves to the CPU.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (CheckpointManager, committed_steps,
                                         latest_step, load_checkpoint)
from repro_torch.core.config import ModelConfig
from repro_torch.data.pipeline import DataConfig, token_batches
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compress import compress_grads, init_compression
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.steps import (TrainState, init_train_state,
                                     loss_and_grads, train_step)

RESIDUAL_DIR = "residual"       # under ckpt_dir: the compression residuals


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

    @property
    def residual_dir(self) -> Optional[str]:
        """Where a compressed run's residuals are committed, a
        ``step_<N>`` directory beside each of the state's (None when the
        run is uncompressed or writes no checkpoints)."""
        if self.loop_cfg.ckpt_dir is None or not self.loop_cfg.compress_grads:
            return None
        return os.path.join(self.loop_cfg.ckpt_dir, RESIDUAL_DIR)

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
        start = self._resume_step()
        if start is not None:
            state, start = load_checkpoint(self.loop_cfg.ckpt_dir, state,
                                           step=start)
            print(f"[loop] restored checkpoint at step {start}")
            if self.residual_dir is not None:
                self._restore_residual(start)
        return state, (start or 0)

    def _resume_step(self) -> Optional[int]:
        """The checkpoint to restore: the latest committed one, or, for a
        compressed run with residuals on disk, the latest with its
        residual committed too: a state whose residual was lost is passed
        over for an older step that resumes the run exactly."""
        if self.loop_cfg.ckpt_dir is None:
            return None
        last = latest_step(self.loop_cfg.ckpt_dir)
        if last is None or self.residual_dir is None:
            return last
        both = (set(committed_steps(self.loop_cfg.ckpt_dir))
                & set(committed_steps(self.residual_dir)))
        return max(both) if both else last

    def _restore_residual(self, step: int) -> None:
        """The residual committed with checkpoint ``step``, or the zeros
        already in place when there is none."""
        if step in committed_steps(self.residual_dir):
            self._comp_state, _ = load_checkpoint(
                self.residual_dir, self._comp_state, step=step)
        else:
            print(f"[loop] no residual at step {step}: zeros")

    def _save(self, step: int, state: TrainState) -> None:
        if self.manager is None:
            return
        first = (None if self.residual_dir is None
                 else (self.residual_dir, self._comp_state))
        self.manager.save_async(step, state, first=first)

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
