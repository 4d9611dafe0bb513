"""Post-training calibration: fp32 CNN params -> int8 pipeline params.

A copy of the JAX package's ``quant/calibrate.py``. :func:`calibrate_cnn`
runs the fp32 reference forward over a calibration stream, observes the
activation range at every fusion-group boundary, and emits a
:class:`QuantizedCNNParams`:

* weights -- per-output-channel symmetric int8;
* activations -- per-tensor scales; each conv / fc / lrn group's
  ``y_scale`` is the requantize target of its epilogue (the next group's
  input scale);
* standalone max-pools pass the scale through (max commutes with the
  int8 map);
* the final classifier keeps fp32 output (``y_scale=None``).

Scales are Python floats; codes and vectors are tensors. The containers
are plain dataclasses (the JAX package registers them as pytrees).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.quant.core import as_scale, quantize_channelwise
from repro_torch.quant.observers import make_observer


@dataclass
class QuantLayer:
    """Quantized state of one layer index of a CNNConfig.

    ``scale`` is the combined requantize multiplier ``x_scale * w_scale``
    ((M,) fp32) the kernel epilogue applies to the int32 accumulator;
    ``y_scale`` the output quantization step (None: fp32 output)."""
    kind: str                                  # "conv" | "fc" | "lrn" | "pool"
    x_scale: float = 1.0
    y_scale: Optional[float] = None
    w_q: Optional[torch.Tensor] = None         # int8
    w_scale: Optional[torch.Tensor] = None     # fp32 (M,), per out-channel
    scale: Optional[torch.Tensor] = None       # fp32 (M,) = x_scale * w_scale
    b: Optional[torch.Tensor] = None           # fp32 bias


@dataclass
class QuantizedCNNParams:
    """Per-layer quantized params aligned with ``cfg.layers`` (None for
    layer indices consumed by a fused group)."""
    layers: List[Optional[QuantLayer]]
    in_scale: float = 1.0                      # network-input quantization


def qparams_from_jax(qp, device) -> QuantizedCNNParams:
    """The JAX package's ``QuantizedCNNParams`` as the port's, on
    ``device``, through numpy: int8 codes and fp32 vectors keep their
    values, the Python-float scales stay as they are."""
    def tensor(a, dtype):
        return None if a is None else torch.from_numpy(
            np.array(a, dtype=dtype)).to(device)

    layers = [None if ql is None else QuantLayer(
        kind=ql.kind, x_scale=ql.x_scale, y_scale=ql.y_scale,
        w_q=tensor(ql.w_q, np.int8), w_scale=tensor(ql.w_scale, np.float32),
        scale=tensor(ql.scale, np.float32), b=tensor(ql.b, np.float32))
        for ql in qp.layers]
    return QuantizedCNNParams(layers=layers, in_scale=qp.in_scale)


def group_forward_ref(params, x: torch.Tensor, cfg
                      ) -> Iterable[Tuple[Tuple[int, ...], torch.Tensor]]:
    """fp32 reference forward, one fusion group at a time: yields
    ``(group, activation_after_group)`` for every group of the fusion
    plan (the boundaries the activation observers watch)."""
    from repro_torch.models.cnn import fuse_plan

    for group in fuse_plan(cfg):
        l = cfg.layers[group[0]]
        p = params[group[0]]
        if l.kind == "conv":
            pool = cfg.layers[group[1]] if len(group) == 2 else None
            x = ref.conv_pipe_ref(
                x, p["w"], p["b"], stride=l.stride, pad=l.pad, relu=l.relu,
                pool=(pool.pool if pool else None),
                pool_k=(pool.kernel if pool else 2),
                pool_s=(pool.stride if pool else 2), groups=l.groups)
        elif l.kind == "pool":
            x = ref.pool_ref(x, l.pool, l.kernel, l.stride)
        elif l.kind == "lrn":
            x = ref.lrn_ref(x)
        elif l.kind == "fc":
            x = ref.matmul_pipe_ref(x.reshape(x.shape[0], -1), p["w"],
                                    p["b"], relu=l.relu)
        yield group, x


def calibrate_cnn(params, calib, cfg, *,
                  observer: str = "absmax") -> QuantizedCNNParams:
    """Calibrate + quantize a CNN for int8 serving, on the device of
    ``params``.

    ``calib`` is one (B, H, W, C) batch (a tensor or an array) or an
    iterable of batches. Deterministic: the same params and batches give
    identical scales and codes. The fp32 forward runs with TF32 off (on
    the card cuDNN would otherwise run it in TF32 and move every scale by
    about 1e-3); the flags are restored afterwards.
    """
    from repro_torch.models.cnn import fuse_plan

    device = next(p["w"].device for p in params if p is not None)
    batches = [calib] if hasattr(calib, "shape") else list(calib)
    if not batches:
        raise ValueError("calibration set is empty")
    plan = fuse_plan(cfg)

    # observe only boundaries whose scale is consumed: standalone
    # max-pools pass the scale through, the final group stays fp32
    def needs_scale(gi: int) -> bool:
        return (gi != len(plan) - 1
                and cfg.layers[plan[gi][0]].kind != "pool")

    obs_in = make_observer(observer)
    obs = [make_observer(observer) if needs_scale(gi) else None
           for gi in range(len(plan))]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            for xb in batches:
                xb = torch.as_tensor(xb, dtype=torch.float32, device=device)
                obs_in.update(xb)
                for gi, (_, act) in enumerate(
                        group_forward_ref(params, xb, cfg)):
                    if obs[gi] is not None:
                        obs[gi].update(act)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    layers: List[Optional[QuantLayer]] = [None] * len(cfg.layers)
    s = obs_in.scale()
    in_scale = s
    for gi, group in enumerate(plan):
        i = group[0]
        l = cfg.layers[i]
        if l.kind in ("conv", "fc"):
            p = params[i]
            w_q, w_scale = quantize_channelwise(p["w"], axis=-1)
            # the final group keeps fp32 output: logits are never requantized
            y = None if gi == len(plan) - 1 else obs[gi].scale()
            layers[i] = QuantLayer(
                kind=l.kind, x_scale=s, y_scale=y, w_q=w_q,
                w_scale=w_scale, scale=w_scale * as_scale(s, w_scale),
                b=p["b"].detach().float())
            s = y if y is not None else s
        elif l.kind == "lrn":
            y = obs[gi].scale()
            layers[i] = QuantLayer(kind="lrn", x_scale=s, y_scale=y)
            s = y
        elif l.kind == "pool":
            if l.pool != "max":
                raise NotImplementedError(
                    "standalone avg-pool has no int8 passthrough; "
                    "dequantize first")
            # max-pool is scale-invariant on int8 codes: passthrough
            layers[i] = QuantLayer(kind="pool", x_scale=s, y_scale=s)
    return QuantizedCNNParams(layers=layers, in_scale=in_scale)
