"""CNN model stack: AlexNet / VGG-16 through the PipeCNN fused pipeline.

The forward is a fold of :func:`run_group` over :func:`fuse_plan`: each
conv(+pool) pair is one fused ``conv_pipe`` launch, LRN runs as its own
kernel (off the pipeline, as in the paper), a standalone pool is a plain
torch op, and FC layers run ``matmul_pipe`` in batched-FC mode.
Parameters are a per-layer list aligned with ``cfg.layers``: ``{"w", "b"}``
for conv (HWIO) and fc ((K, N)) layers, ``None`` for pool and lrn — the
JAX package's layout, so parameters carry over with no transpose.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.config import CNNConfig, fuse_groups
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pool_ref

Params = List[Optional[Dict[str, torch.Tensor]]]


def init_cnn_params(cfg: CNNConfig, *, generator: torch.Generator,
                    device) -> Params:
    """Random parameters with the JAX package's scaling: He-normal conv
    weights, 1/sqrt(fan_in) fc weights, zero biases. Drawn on the
    generator's device, then moved to ``device``. (torch's RNG cannot
    reproduce ``jax.random``; carry JAX parameters with
    :func:`params_from_jax`.)"""
    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std).to(device)

    params: Params = []
    c, hw = cfg.input_ch, cfg.input_hw
    for l in cfg.layers:
        if l.kind == "conv":
            cg = c // l.groups
            params.append({
                "w": normal((l.kernel, l.kernel, cg, l.out_ch),
                            math.sqrt(2.0 / (l.kernel * l.kernel * cg))),
                "b": torch.zeros(l.out_ch, device=device)})
            hw = (hw + 2 * l.pad - l.kernel) // l.stride + 1
            c = l.out_ch
        elif l.kind == "pool":
            params.append(None)
            hw = (hw - l.kernel) // l.stride + 1
        elif l.kind == "lrn":
            params.append(None)
        else:
            fan_in = c * hw * hw
            params.append({
                "w": normal((fan_in, l.out_ch), 1.0 / math.sqrt(fan_in)),
                "b": torch.zeros(l.out_ch, device=device)})
            hw, c = 1, l.out_ch
    return params


def params_from_jax(params: Sequence[Optional[Dict[str, Any]]],
                    device) -> Params:
    """The JAX package's per-layer parameter list (numpy or any array
    ``np.asarray`` takes) as the port's, on ``device``. No transposes: both
    sides keep HWIO conv and (K, N) fc weights."""
    return [None if p is None else
            {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
             for k, v in p.items()}
            for p in params]


def fuse_plan(cfg: CNNConfig) -> List[Tuple[int, ...]]:
    """The fusion groups the forward folds over (``core.config.fuse_groups``)."""
    return fuse_groups(cfg.layers)


def run_group(params: Params, x: torch.Tensor, cfg: CNNConfig,
              group: Tuple[int, ...], *, use_kernels: bool = True
              ) -> torch.Tensor:
    """Execute ONE fusion group of the fp32 pipeline on NHWC ``x``."""
    l = cfg.layers[group[0]]
    p = params[group[0]]
    if l.kind == "conv":
        pool = cfg.layers[group[1]] if len(group) == 2 else None
        # grouped conv (AlexNet two-tower) runs inside the one launch
        return ops.fused_conv(
            x, p["w"], p["b"], stride=l.stride, pad=l.pad, relu=l.relu,
            pool=pool.pool if pool else None,
            pool_k=pool.kernel if pool else 2,
            pool_s=pool.stride if pool else 2, groups=l.groups,
            use_kernels=use_kernels)
    if l.kind == "pool":
        return pool_ref(x, l.pool, l.kernel, l.stride)
    if l.kind == "lrn":
        return ops.lrn(x, use_kernels=use_kernels)
    # fc: flatten in NHWC order, as the JAX package does before fc6
    return ops.fc(x.reshape(x.shape[0], -1), p["w"], p["b"], relu=l.relu,
                  use_kernels=use_kernels)


def cnn_forward_stage(params: Params, x: torch.Tensor, cfg: CNNConfig,
                      groups, *, use_kernels: bool = True) -> torch.Tensor:
    """Run a contiguous slice of fusion groups — one pipeline stage."""
    for group in groups:
        x = run_group(params, x, cfg, group, use_kernels=use_kernels)
    return x


class CNN(nn.Module):
    """The whole network as a module: x (B, H, W, C) -> logits.

    Holds the per-layer parameters (moved by ``.to``) and folds
    :func:`run_group` over :func:`fuse_plan`.
    """

    def __init__(self, cfg: CNNConfig, params: Params, *,
                 use_kernels: bool = True):
        super().__init__()
        if len(params) != len(cfg.layers):
            raise ValueError(f"{len(params)} parameter entries for "
                             f"{len(cfg.layers)} layers of {cfg.name!r}")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.groups = fuse_plan(cfg)
        for i, p in enumerate(params):
            if p is not None:
                for k in ("w", "b"):
                    self.register_parameter(
                        f"{k}{i}", nn.Parameter(p[k], requires_grad=False))

    @property
    def params(self) -> Params:
        return [{"w": getattr(self, f"w{i}"), "b": getattr(self, f"b{i}")}
                if hasattr(self, f"w{i}") else None
                for i in range(len(self.cfg.layers))]

    def forward_groups(self, x: torch.Tensor, groups) -> torch.Tensor:
        return cnn_forward_stage(self.params, x, self.cfg, groups,
                                 use_kernels=self.use_kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_groups(x, self.groups)
