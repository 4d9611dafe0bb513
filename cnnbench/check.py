"""The comparison that decides ``correct``, and its control.

After the window has closed and the program's state is freed, the
reference (:mod:`cnnbench.reference`) runs in the configuration's stated
precision on weights and images drawn again from the seed, and each
number below is held to its limit (``limits/<workload>.json``):

* ``top1_gap`` and ``top1_gap_mean`` (an open mix, served predictions):
  for every request of the window, how far the reference's logit of the
  served class lies below the reference's best, in units of the row's
  standard deviation; the widest, and the mean, over the window. A request
  that never came back reads inf.
* ``logit_err`` (a closed mix, logits): for every forward kept from the
  window (a seeded sample and the last), the largest absolute difference
  between the program's logits and the reference's, over the largest
  reference logit; the widest over the kept forwards. ``top1_gap`` and
  ``top1_gap_mean`` of a closed mix are those of the program's best class
  of each kept row. A cell compares the numbers its limits file names.

The control is the nearest lower precision in the program's place, run
through the same window and the same comparison as the program
(``harness.run_cell(..., control=True)``): for a bf16 configuration the
program's own int8 path, for an int8 configuration the reference in int4
(:class:`LowerReference`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from cnnbench import reference, traffic

LOWER = {"int8": "int4"}
# images a block of the reference's forward
REF_BLOCK = 32


def ref_precision(cfg: dict) -> str:
    p = cfg["precision"]
    return "int8" if p.get("quant", "none") == "int8" else p["dtype"]


def pool_logits(cfg: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """The reference's logits of every pool image of an open mix."""
    pool = traffic.pool(cfg, mix, seed, device)
    return reference.logits(cfg, traffic.model_weights(cfg, seed, device),
                            pool, ref_precision(cfg),
                            calib=traffic.calib(cfg, seed, device),
                            block=REF_BLOCK)


def _gap_numbers(gaps: torch.Tensor) -> Dict[str, float]:
    if not len(gaps):
        return {"top1_gap": float("inf"), "top1_gap_mean": float("inf")}
    return {"top1_gap": float(gaps.max()),
            "top1_gap_mean": float(gaps.double().mean())}


def served_numbers(cfg: dict, mix: dict, seed: int, device,
                   picks: np.ndarray, preds: np.ndarray) -> Dict[str, float]:
    """``top1_gap`` and ``top1_gap_mean`` over served requests carrying
    pool images ``picks`` that came back as ``preds`` (-1: never came
    back)."""
    ref = pool_logits(cfg, mix, seed, device)
    return _gap_numbers(reference.top1_gap(
        ref[torch.as_tensor(picks, device=device)],
        torch.as_tensor(preds, device=device)))


def rotation_logits(cfg: dict, mix: dict, seed: int, device, slots
                    ) -> Dict[int, torch.Tensor]:
    """The reference's logits of each rotation batch in ``slots``."""
    params = traffic.model_weights(cfg, seed, device)
    calib = traffic.calib(cfg, seed, device)
    out = {}
    for s in sorted(set(slots)):
        x = traffic.rotation(cfg, mix, seed, device, s)
        out[s] = reference.logits(cfg, params, x, ref_precision(cfg),
                                  calib=calib, block=REF_BLOCK)
    return out


def offline_numbers(cfg: dict, mix: dict, seed: int, device,
                    kept: List[Tuple[int, torch.Tensor]]) -> Dict[str, float]:
    """Over kept ``(forward index, logits)``: the widest ``logit_err`` (inf
    where a logit is NaN or nothing was kept), and ``top1_gap`` and
    ``top1_gap_mean`` of the program's best class of every kept row."""
    rot = mix["rotation"]
    ref = rotation_logits(cfg, mix, seed, device, [i % rot for i, _ in kept])
    worst, gaps = (0.0 if kept else math.inf), []
    for i, y in kept:
        r, y = ref[i % rot], y.float()
        err = float((y - r).abs().max() / r.abs().max())
        worst = max(worst, math.inf if math.isnan(err) else err)
        gaps.append(reference.top1_gap(r, y.argmax(dim=1)))
    return {"logit_err": worst,
            **_gap_numbers(torch.cat(gaps) if gaps else torch.empty(0))}


class LowerReference:
    """The control of a fixed-point configuration in the program's place:
    the reference one step lower (int8 -> int4), calibrated once on the
    configuration's calibration batch, with the program's ``forward``."""

    def __init__(self, cfg: dict, params, calib: torch.Tensor, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.qmax = reference.QMAX[LOWER[ref_precision(cfg)]]
        self.qm = reference.calibrate(cfg, params, calib, self.qmax)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([reference.forward_fixed(self.cfg, self.qm,
                                                  x[i:i + REF_BLOCK],
                                                  self.qmax)
                          for i in range(0, len(x), REF_BLOCK)])
