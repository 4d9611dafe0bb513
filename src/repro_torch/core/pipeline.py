"""The PipeCNN execution model as numbers: the global-memory traffic of a
layer sequence, fused and unfused.

PipeCNN's claim: cascading MemRD -> Conv -> Pool -> MemWR through on-chip
channels removes the inter-stage global-memory round trip, cutting the
bandwidth requirement against separate kernels. ``bandwidth_model``
computes the traffic of a layer sequence in fused and unfused execution;
the port's ``conv_pipe`` runs the fused cascade (a conv and its pool in one
launch, the unpooled map never written).

The port's copy of the JAX package's ``core/pipeline.py``, integer for
integer. JAX's ``measure_traffic`` reads XLA's compiled cost analysis and
has no counterpart without XLA; ``chip_smoke.py`` phase 18 times each
VGG-16 conv+pool group fused and unfused on the card beside these bytes
instead.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.config import CNNConfig


@dataclasses.dataclass
class StageTraffic:
    name: str
    read_bytes: int
    write_bytes: int

    @property
    def total(self) -> int:
        return self.read_bytes + self.write_bytes


def _layer_shapes(cfg: CNNConfig):
    """Yield (layer, in_shape, out_shape) with NHWC shapes per image."""
    h = w = cfg.input_hw
    c = cfg.input_ch
    for l in cfg.layers:
        in_shape = (h, w, c)
        if l.kind == "conv":
            h = (h + 2 * l.pad - l.kernel) // l.stride + 1
            w = (w + 2 * l.pad - l.kernel) // l.stride + 1
            c = l.out_ch
        elif l.kind == "pool":
            h = (h - l.kernel) // l.stride + 1
            w = (w - l.kernel) // l.stride + 1
        elif l.kind == "fc":
            h, w, c = 1, 1, l.out_ch
        yield l, in_shape, (h, w, c)


def bandwidth_model(cfg: CNNConfig, batch: int = 1, fused: bool = True,
                    dtype_bytes: int = 4) -> List[StageTraffic]:
    """Analytic global-memory traffic per pipeline stage (weights +
    activations).

    Unfused (the FPGA'16 [4] organization): every stage reads its input
    from and writes its output to global memory. Fused (PipeCNN): a
    conv+pool group touches memory once; the pool's input stays on chip.
    """
    from repro_torch.models.cnn import fuse_plan

    plan = (fuse_plan(cfg) if fused
            else [(i,) for i in range(len(cfg.layers))])
    shapes = list(_layer_shapes(cfg))
    out: List[StageTraffic] = []
    px = lambda s: int(np.prod(s)) * dtype_bytes * batch  # noqa: E731
    for group in plan:
        l, in_shape, _ = shapes[group[0]]
        _, _, out_shape = shapes[group[-1]]
        w_bytes = 0
        if l.kind == "conv":
            w_bytes = (l.kernel * l.kernel * (in_shape[2] // l.groups)
                       * l.out_ch) * dtype_bytes
        elif l.kind == "fc":
            w_bytes = int(np.prod(in_shape)) * l.out_ch * dtype_bytes
        name = "+".join(cfg.layers[i].kind for i in group)
        out.append(StageTraffic(name, px(in_shape) + w_bytes, px(out_shape)))
    return out


def im2col_gemm_traffic(cfg: CNNConfig, batch: int = 1,
                        dtype_bytes: int = 4) -> int:
    """Global-memory traffic of the FPGA'16 [4] organization PipeCNN
    compares against: conv as explicit im2col + GEMM, the patch matrix
    (OH x OW, K*K*C) materialised in global memory (written once, read
    once), which multiplies activation traffic by about K^2."""
    total = 0
    for l, in_shape, out_shape in _layer_shapes(cfg):
        px_in = int(np.prod(in_shape)) * dtype_bytes * batch
        px_out = int(np.prod(out_shape)) * dtype_bytes * batch
        if l.kind == "conv":
            oh, ow, m = out_shape
            cg = in_shape[2] // l.groups
            patches = oh * ow * l.kernel * l.kernel * cg \
                * dtype_bytes * batch
            w_bytes = l.kernel * l.kernel * cg * m * dtype_bytes
            total += px_in + 2 * patches + w_bytes + px_out
        elif l.kind == "fc":
            w_bytes = int(np.prod(in_shape)) * out_shape[2] * dtype_bytes
            total += px_in + w_bytes + px_out
        else:
            total += px_in + px_out
    return total


def fusion_savings(cfg: CNNConfig, batch: int = 1) -> Tuple[int, int, float]:
    """(unfused_bytes, fused_bytes, reduction_fraction) at 4 bytes an
    element."""
    unf = sum(s.total for s in bandwidth_model(cfg, batch, fused=False))
    fus = sum(s.total for s in bandwidth_model(cfg, batch, fused=True))
    return unf, fus, 1.0 - fus / unf
