"""The one general generator of the benchmark's inputs, driven by the
parameters of a traffic file (``traffic/<mix>.json``), and the seeded
weights.

A mix is ``"open"`` (independent users: arrivals on a schedule, whatever
the server does) or ``"closed"`` (a stored image set classified batch
after batch). Keys:

* ``arrivals``: ``"open"`` or ``"closed"``;
* ``batch``: the serving batch the program is compiled at;
* ``rate_per_s`` (open): the offered rate. The gaps between arrivals are
  the quantiles of an exponential law of that mean, shuffled by the seed,
  so every seed offers the same set of gaps in another order;
* ``pool`` (open): distinct images; each request draws one from the seed;
* ``rotation`` (closed): distinct input batches, cycled;
* ``check_share`` (closed): the share of the window's forwards whose
  outputs are kept for the correctness check, drawn from the seed.

Every number comes from ``--seed`` alone; the images and weights are
drawn on the device, in a few large calls.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from cnnbench.config import layer_shapes, layers, source

# stream ids: each random draw of a run has its own, so one draw never
# shifts another
WEIGHTS, BIASES, IMAGES, CALIB, ARRIVALS, PICKS, KEEP, CENTER = range(8)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 63, stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    s = int(np.random.SeedSequence([seed % 2 ** 63, stream])
            .generate_state(1, np.uint64)[0]) % 2 ** 63
    return torch.Generator(device=device).manual_seed(s)


def arrivals(mix: dict, seed: int, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of every request of an open
    mix within ``seconds``."""
    rate = float(mix["rate_per_s"])
    n = int(round(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    due = np.cumsum(rng(seed, ARRIVALS).permutation(gaps))
    return due[due < seconds]


def picks(mix: dict, seed: int, n: int) -> np.ndarray:
    """The pool image each of ``n`` requests carries."""
    return rng(seed, PICKS).integers(0, mix["pool"], size=n)


def keep_mask(mix: dict, seed: int, n: int) -> np.ndarray:
    """Which of the first ``n`` forwards of a closed mix keep their output
    for the check."""
    return rng(seed, KEEP).random(n) < mix["check_share"]


def images(cfg: dict, n: int, seed: int, stream: int, device
           ) -> torch.Tensor:
    """``n`` standard-normal fp32 images (n, H, W, C) on ``device``."""
    hw, ch = cfg["input_hw"], cfg["input_ch"]
    return torch.randn((n, hw, hw, ch), generator=torch_gen(seed, stream,
                                                            device),
                       device=device)


def pool(cfg: dict, mix: dict, seed: int, device) -> torch.Tensor:
    """The distinct images of an open mix."""
    return images(cfg, mix["pool"], seed, IMAGES, device)


def rotation(cfg: dict, mix: dict, seed: int, device, slot: int
             ) -> torch.Tensor:
    """Input batch ``slot`` of a closed mix's rotation."""
    return images(cfg, mix["batch"], seed, IMAGES + 1000 * slot, device)


def calib(cfg: dict, seed: int, device, n: int = None):
    """The calibration batch of a fixed-point configuration (None for a
    float one), or ``n`` images from the same stream."""
    n = n if n is not None else cfg["precision"].get("calib_images", 0)
    return images(cfg, n, seed, CALIB, device) if n else None


def weights(cfg: dict, seed: int, device, dtype: torch.dtype
            ) -> List[Optional[Dict[str, torch.Tensor]]]:
    """The model's parameters in ``dtype`` on ``device``, aligned with the
    configuration's layers (None for a pool or an LRN): HWIO conv weights
    He-normal, their input channels those of the output the conv reads,
    (K, N) FC weights with standard deviation 1/sqrt(K), biases normal
    with ``weights.bias_std``. Two draws in all (weights, biases), each one
    call over the whole model, then scaled in place."""
    shapes, fans, outs = [], [], []
    ls, out_shapes = layers(cfg), layer_shapes(cfg)
    image = (cfg["input_hw"], cfg["input_hw"], cfg["input_ch"])
    for i, l in enumerate(ls):
        j = source(ls, i)
        shape = image if j == -1 else out_shapes[j]
        if l["kind"] == "conv":
            cg = shape[2] // l["groups"]
            shapes.append((l["kernel"], l["kernel"], cg, l["out_ch"]))
            fans.append(2.0 / (l["kernel"] ** 2 * cg))
            outs.append(l["out_ch"])
        elif l["kind"] == "fc":
            k = math.prod(shape)
            shapes.append((k, l["out_ch"]))
            fans.append(1.0 / k)
            outs.append(l["out_ch"])
        else:
            shapes.append(None)
            fans.append(None)
            outs.append(None)
    n_w = sum(math.prod(s) for s in shapes if s)
    n_b = sum(o for o in outs if o)
    flat_w = torch.randn(n_w, generator=torch_gen(seed, WEIGHTS, device),
                         device=device, dtype=dtype)
    flat_b = torch.randn(n_b, generator=torch_gen(seed, BIASES, device),
                         device=device, dtype=dtype)
    flat_b.mul_(cfg["weights"]["bias_std"])
    params, iw, ib = [], 0, 0
    for s, var, o in zip(shapes, fans, outs):
        if s is None:
            params.append(None)
            continue
        w = flat_w[iw:iw + math.prod(s)].view(s).mul_(math.sqrt(var))
        params.append({"w": w, "b": flat_b[ib:ib + o]})
        iw += math.prod(s)
        ib += o
    return params


def model_weights(cfg: dict, seed: int, device) -> List[Optional[Dict]]:
    """The parameters both the program and the reference are given, in the
    configuration's float dtype: :func:`weights`, and where the
    configuration's ``weights.center_logits`` asks for it, the last FC's
    bias set to minus the mean of its product over 64 images of the seed
    (the reference's forward in that dtype). A random deep ReLU network
    maps every image to nearly the same logits, so its class would not
    depend on the image; centred, it does, as a trained classifier's."""
    from cnnbench import reference
    dt = torch.bfloat16 if cfg["precision"]["dtype"] == "bfloat16" \
        else torch.float32
    params = weights(cfg, seed, device, dt)
    if cfg["weights"].get("center_logits"):
        last = params[-1]
        last["b"].zero_()
        x = images(cfg, 64, seed, CENTER, device)
        mean = reference.forward(cfg, params, x,
                                 cfg["precision"]["dtype"]).mean(dim=0)
        last["b"].copy_(-mean)
    return params
