"""CNN model stack: AlexNet / VGG-16 through the PipeCNN fused pipeline.

The forward is a fold of :func:`run_group` over :func:`fuse_plan`: each
conv(+pool) pair is one fused ``conv_pipe`` launch, LRN runs as its own
kernel (off the pipeline, as in the paper), a standalone pool is a plain
torch op, and FC layers run ``matmul_pipe`` in batched-FC mode.
Parameters are a per-layer list aligned with ``cfg.layers``: ``{"w", "b"}``
for conv (HWIO) and fc ((K, N)) layers, ``None`` for pool and lrn — the
JAX package's layout, so parameters carry over with no transpose.

Fixed-point serving (the paper's precision trade): with a
:class:`~repro_torch.quant.QuantizedCNNParams` (from ``calibrate_cnn``)
the same groups run in int8 (:func:`run_group_quant`): the batch is
quantized at the network edge, int8 codes flow between groups, conv and
fc run the int8 kernel modes (int32 accumulation, requantize epilogue),
standalone max-pools run on the codes, and LRN runs off the fixed-point
pipeline as in the paper, in its kernel's int8 mode (dequantize, LRN,
requantize in one pass). The final fc emits fp32 logits.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.config import CNNConfig, fuse_groups
from repro_torch.kernels import ops
from repro_torch.kernels.ref import pool_ref
from repro_torch.quant.calibrate import QuantizedCNNParams, QuantLayer

Params = List[Optional[Dict[str, torch.Tensor]]]


def init_cnn_params(cfg: CNNConfig, *, generator: torch.Generator,
                    device, dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters with the JAX package's scaling: He-normal conv
    weights, 1/sqrt(fan_in) fc weights, zero biases. Drawn in fp32 on the
    generator's device, then cast to ``dtype`` (the run dtype, as the JAX
    package casts to ``cfg.dtype``) on ``device``. (torch's RNG cannot
    reproduce ``jax.random``; carry JAX parameters with
    :func:`params_from_jax`.)"""
    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return (t * std).to(device=device, dtype=dtype)

    params: Params = []
    c, hw = cfg.input_ch, cfg.input_hw
    for l in cfg.layers:
        if l.kind == "conv":
            cg = c // l.groups
            params.append({
                "w": normal((l.kernel, l.kernel, cg, l.out_ch),
                            math.sqrt(2.0 / (l.kernel * l.kernel * cg))),
                "b": torch.zeros(l.out_ch, device=device, dtype=dtype)})
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
                "b": torch.zeros(l.out_ch, device=device, dtype=dtype)})
            hw, c = 1, l.out_ch
    return params


def params_from_jax(params: Sequence[Optional[Dict[str, Any]]],
                    device) -> Params:
    """The JAX package's per-layer parameter list (numpy or any array
    ``np.asarray`` takes) as the port's, on ``device``: bf16 stays bf16
    (through fp32, which holds it exactly), anything else becomes fp32.
    No transposes: both sides keep HWIO conv and (K, N) fc weights."""
    def tensor(v):
        a = np.asarray(v)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a, dtype=np.float32))

    return [None if p is None else
            {k: tensor(v).to(device) for k, v in p.items()}
            for p in params]


def fuse_plan(cfg: CNNConfig) -> List[Tuple[int, ...]]:
    """The fusion groups the forward folds over (``core.config.fuse_groups``)."""
    return fuse_groups(cfg.layers)


def _plan_kw(plans, group, kind: str) -> Dict[str, Any]:
    """The kernel keyword a frozen plan gives ``group``: ``tile`` for a
    conv, ``split`` for an FC; none without a plan (the kernel's rule)."""
    plan = plans.get(group) if plans is not None else None
    if plan is None:
        return {}
    return {"tile": plan.tile} if kind == "conv" else {"split": plan.split}


def run_group(params: Params, x: torch.Tensor, cfg: CNNConfig,
              group: Tuple[int, ...], *, use_kernels: bool = True,
              plans=None) -> torch.Tensor:
    """Execute ONE fusion group of the fp32 or bf16 pipeline on NHWC ``x``
    (the dtype of ``x`` and the parameters).

    ``plans`` maps a group to its frozen plan (a compiled pipeline's
    ``ConvPlan`` / ``GemmPlan``), which pins the kernel's tile or split; a
    group without one launches with the kernel's own rule. The oracles
    (``use_kernels=False``) take none."""
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
            use_kernels=use_kernels, **_plan_kw(plans, group, "conv"))
    if l.kind == "pool":
        return pool_ref(x, l.pool, l.kernel, l.stride)
    if l.kind == "lrn":
        return ops.lrn(x, use_kernels=use_kernels)
    # fc: flatten in NHWC order, as the JAX package does before fc6
    return ops.fc(x.reshape(x.shape[0], -1), p["w"], p["b"], relu=l.relu,
                  use_kernels=use_kernels, **_plan_kw(plans, group, "fc"))


def cnn_forward_stage(params: Params, x: torch.Tensor, cfg: CNNConfig,
                      groups, *, use_kernels: bool = True,
                      plans=None) -> torch.Tensor:
    """Run a contiguous slice of fusion groups — one pipeline stage."""
    for group in groups:
        x = run_group(params, x, cfg, group, use_kernels=use_kernels,
                      plans=plans)
    return x


class CNN(nn.Module):
    """The whole network as a module: x (B, H, W, C) -> logits, in the
    parameters' dtype (fp32 or bf16, the batch in the same dtype).

    Holds the per-layer parameters (moved by ``.to``) and folds
    :func:`run_group` over :func:`fuse_plan`, with the frozen ``plans``
    (group -> plan) a compile resolved.
    """

    def __init__(self, cfg: CNNConfig, params: Params, *,
                 use_kernels: bool = True, plans=None):
        super().__init__()
        if len(params) != len(cfg.layers):
            raise ValueError(f"{len(params)} parameter entries for "
                             f"{len(cfg.layers)} layers of {cfg.name!r}")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.plans = dict(plans or {})
        self.groups = fuse_plan(cfg)
        for i, p in enumerate(params):
            if p is not None:
                for k in ("w", "b"):
                    self.register_parameter(
                        f"{k}{i}", nn.Parameter(p[k], requires_grad=False))

    @property
    def in_dtype(self) -> torch.dtype:
        """The dtype the forward takes its batch in: the parameters'."""
        return next(self.parameters()).dtype

    @property
    def params(self) -> Params:
        return [{"w": getattr(self, f"w{i}"), "b": getattr(self, f"b{i}")}
                if hasattr(self, f"w{i}") else None
                for i in range(len(self.cfg.layers))]

    def forward_groups(self, x: torch.Tensor, groups) -> torch.Tensor:
        return cnn_forward_stage(self.params, x, self.cfg, groups,
                                 use_kernels=self.use_kernels,
                                 plans=self.plans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_groups(x, self.groups)


# ---------------------------------------------------------------------------
# the int8 pipeline
# ---------------------------------------------------------------------------

def run_group_quant(qp: QuantizedCNNParams, q: torch.Tensor, cfg: CNNConfig,
                    group: Tuple[int, ...], *, use_kernels: bool = True,
                    plans=None) -> torch.Tensor:
    """Execute ONE fusion group of the int8 pipeline on int8 codes; every
    scale it needs is a constant inside ``qp``. ``plans`` as in
    :func:`run_group`."""
    l = cfg.layers[group[0]]
    ql = qp.layers[group[0]]
    if l.kind == "conv":
        pool = cfg.layers[group[1]] if len(group) == 2 else None
        return ops.fused_conv_q(
            q, ql.w_q, ql.b, ql.scale, out_scale=ql.y_scale, stride=l.stride,
            pad=l.pad, relu=l.relu, pool=pool.pool if pool else None,
            pool_k=pool.kernel if pool else 2,
            pool_s=pool.stride if pool else 2, groups=l.groups,
            use_kernels=use_kernels, **_plan_kw(plans, group, "conv"))
    if l.kind == "pool":
        # max-pool commutes with the int8 map: pool the codes, keep scale
        return ops.pool_q(q, pool=l.pool, k=l.kernel, s=l.stride,
                          use_kernels=use_kernels)
    if l.kind == "lrn":
        # LRN is nonlinear in scale: run it off the fixed-point pipeline
        # (as PipeCNN does) and requantize its output
        return ops.lrn_q(q, ql.x_scale, ql.y_scale, use_kernels=use_kernels)
    return ops.fc_q(q.reshape(q.shape[0], -1), ql.w_q, ql.b, ql.scale,
                    relu=l.relu, out_scale=ql.y_scale,
                    use_kernels=use_kernels, **_plan_kw(plans, group, "fc"))


def cnn_forward_stage_quant(qp: QuantizedCNNParams, q: torch.Tensor,
                            cfg: CNNConfig, groups, *,
                            use_kernels: bool = True,
                            plans=None) -> torch.Tensor:
    """Run a contiguous slice of int8 fusion groups (one pipeline stage).
    ``q`` is int8 codes at an interior boundary, or the raw fp32 batch
    for the first stage, which is quantized at the network edge."""
    if q.dtype != torch.int8:
        q = ops.quantize_q(q, qp.in_scale, use_kernels=use_kernels)
    for group in groups:
        q = run_group_quant(qp, q, cfg, group, use_kernels=use_kernels,
                            plans=plans)
    return q


def _quant_groups(qp: QuantizedCNNParams, x: torch.Tensor, cfg: CNNConfig,
                  *, use_kernels: bool = True):
    """Run the int8 pipeline one fusion group at a time, yielding
    ``(group, activation, scale)``: int8 codes with step ``scale``, or the
    final fp32 logits with ``scale=None``."""
    q = ops.quantize_q(x, qp.in_scale, use_kernels=use_kernels)
    s = qp.in_scale
    for group in fuse_plan(cfg):
        l = cfg.layers[group[0]]
        ql = qp.layers[group[0]]
        q = run_group_quant(qp, q, cfg, group, use_kernels=use_kernels)
        if l.kind != "pool":           # pool passes the scale through
            s = ql.y_scale
        yield group, q, s


def cnn_forward_quant(qp: QuantizedCNNParams, x: torch.Tensor,
                      cfg: CNNConfig, *, use_kernels: bool = True
                      ) -> torch.Tensor:
    """int8 pipeline forward: x (B, H, W, C) fp32 -> fp32 logits."""
    out = None
    for _, out, _ in _quant_groups(qp, x, cfg, use_kernels=use_kernels):
        pass
    return out


def cnn_forward(params, x: torch.Tensor, cfg: CNNConfig, *,
                use_kernels: bool = False, fused: bool = True
                ) -> torch.Tensor:
    """Deprecated: x (B, H, W, C) -> logits (B, n_classes) by a fold over
    the layers, the JAX package's free function (its ``use_pallas`` is
    ``use_kernels`` here, off by default as there). A
    :class:`QuantizedCNNParams` runs the int8 pipeline; ``fused=False``
    runs every layer as its own group (a conv and its pool apart). The
    compile-once entry point is ``compile_cnn(cfg, spec, params)
    .forward(x)``."""
    warnings.warn("cnn_forward is deprecated: compile_cnn(cfg, spec, "
                  "params).forward(x)", DeprecationWarning, stacklevel=2)
    with torch.inference_mode():
        if isinstance(params, QuantizedCNNParams):
            return cnn_forward_quant(params, x, cfg, use_kernels=use_kernels)
        groups = fuse_plan(cfg) if fused else \
            [(i,) for i in range(len(cfg.layers))]
        return cnn_forward_stage(params, x, cfg, groups,
                                 use_kernels=use_kernels)


_QTENSORS = ("w_q", "w_scale", "scale", "b")


class QuantCNN(nn.Module):
    """The int8 network as a module: x (B, H, W, C) fp32 -> fp32 logits.

    Holds a :class:`QuantizedCNNParams`: int8 codes and fp32 vectors as
    buffers (moved by ``.to``), scales as Python floats. Folds
    :func:`run_group_quant` over :func:`fuse_plan`; the same interface as
    :class:`CNN`."""

    def __init__(self, cfg: CNNConfig, qparams: QuantizedCNNParams, *,
                 use_kernels: bool = True, plans=None):
        super().__init__()
        if len(qparams.layers) != len(cfg.layers):
            raise ValueError(f"{len(qparams.layers)} quantized entries for "
                             f"{len(cfg.layers)} layers of {cfg.name!r}")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.plans = dict(plans or {})
        self.groups = fuse_plan(cfg)
        self.in_scale = qparams.in_scale
        self._scales = [None if ql is None else (ql.kind, ql.x_scale,
                                                 ql.y_scale)
                        for ql in qparams.layers]
        for i, ql in enumerate(qparams.layers):
            for k in _QTENSORS:
                if ql is not None and getattr(ql, k) is not None:
                    self.register_buffer(f"{k}{i}", getattr(ql, k))

    @property
    def in_dtype(self) -> torch.dtype:
        """The dtype the forward takes its batch in (it quantizes at the
        network edge)."""
        return torch.float32

    @property
    def qparams(self) -> QuantizedCNNParams:
        layers = []
        for i, sc in enumerate(self._scales):
            if sc is None:
                layers.append(None)
                continue
            kind, x_scale, y_scale = sc
            layers.append(QuantLayer(kind=kind, x_scale=x_scale,
                                     y_scale=y_scale, **{
                                         k: getattr(self, f"{k}{i}", None)
                                         for k in _QTENSORS}))
        return QuantizedCNNParams(layers=layers, in_scale=self.in_scale)

    def forward_groups(self, x: torch.Tensor, groups) -> torch.Tensor:
        return cnn_forward_stage_quant(self.qparams, x, self.cfg, groups,
                                       use_kernels=self.use_kernels,
                                       plans=self.plans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_groups(x, self.groups)


def classification_flops(cfg: CNNConfig) -> int:
    """Operations of one image's forward (2 a multiply-accumulate), the
    paper's GOPS numerator: ``core.config.flops_per_image``."""
    from repro_torch.core.config import flops_per_image
    return flops_per_image(cfg)
