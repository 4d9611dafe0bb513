"""CNN serving engine of the port: one replica, gang rounds, measured clock.

The JAX package's ``ServeEngine`` (``serve/engine.py``) cut to its
single-replica gang loop: arrivals are admitted up to the clock, each
round drains one micro-batch padded to the plan batch, runs the compiled
forward on the device and advances the clock by the round's wall time
(host clock around work that ends in a device-to-host copy of the
predictions, which waits for the device). The first round's forward runs
once outside the clock, as the JAX engine compiles outside it; here that
builds the CUDA kernels.
"""
from __future__ import annotations

import time
from typing import List, Tuple, Union

import numpy as np
import torch

from repro_torch.models.cnn import CNN, QuantCNN
from repro_torch.pipeline.spec import LATER_FLEET, ExecutionSpec, refuse
from repro_torch.serve.report import FleetReport, fleet_report
from repro_torch.serve.router import Completion, Request, Router


class ServeEngine:
    """Serves request streams through ``model`` (fp32, bf16 or int8) on the
    device of its first tensor: a parameter, or a buffer of an int8
    model, which has no parameters."""

    def __init__(self, model: Union[CNN, QuantCNN], *, batch: int = 8,
                 max_queue: int = 0, slo: float = 0.0):
        self.model = model
        self.cfg = model.cfg
        self.batch = batch
        self.slo = float(slo)
        self.device = next(iter(model.state_dict().values())).device
        self.router = Router(1, batch, max_queue=max_queue)
        self._warm = False

    @classmethod
    def from_spec(cls, model: Union[CNN, QuantCNN],
                  spec: ExecutionSpec) -> "ServeEngine":
        return cls(model, batch=spec.serving.batch,
                   max_queue=spec.serving.max_queue, slo=spec.serving.slo)

    def hot_swap(self, artifact, *, at: float = 0.0) -> int:
        raise refuse("ServeEngine.hot_swap", "hot_swap", LATER_FLEET)

    def _preds(self, imgs: np.ndarray) -> np.ndarray:
        """The padded batch, converted to the model's input dtype, ->
        the argmax of the logits widened to fp32, as the JAX engine takes
        it."""
        x = torch.from_numpy(imgs).to(self.device, self.model.in_dtype)
        with torch.inference_mode():
            return self.model(x).float().argmax(-1).cpu().numpy()

    def serve(self, requests: List[Request]
              ) -> Tuple[List[Completion], FleetReport]:
        """Drain a request stream; returns (completions, report). Every
        admitted request ends as exactly one completion."""
        router = self.router
        done: List[Completion] = []
        pending = sorted(requests, key=lambda r: r.t_arrival)
        clock = busy = 0.0
        rounds = 0
        while True:
            while pending and pending[0].t_arrival <= clock:
                router.dispatch(pending.pop(0))
            if not router.backlog():
                if not pending:
                    break
                clock = max(clock, pending[0].t_arrival)
                continue
            [(_, take, imgs, n_real)] = router.drain_round()
            if not self._warm:
                self._preds(imgs)
                self._warm = True
            # repro: allow[RPA102] the measured clock measures
            t0 = time.perf_counter()
            preds = self._preds(imgs)
            # repro: allow[RPA102] the measured clock measures
            t_wall = time.perf_counter() - t0
            clock += t_wall
            busy += t_wall
            rounds += 1
            for req, pred in zip(take, preds[:n_real]):
                done.append(Completion(rid=req.rid, pred=int(pred),
                                       t_arrival=req.t_arrival,
                                       t_done=clock))
        rep = fleet_report(done, router.rejected, mode="single", replicas=1,
                           pp_stages=1, batch=self.batch, clock="measured",
                           rounds=rounds, busy_s=[busy], makespan_s=clock,
                           slo_s=self.slo, device=str(self.device))
        return done, rep
