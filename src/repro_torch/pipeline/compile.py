"""compile_cnn: the compile phase of the port's pipeline.

``compile_cnn(cfg, spec)`` resolves the parameters, the precision, the
device and the spec into an immutable :class:`CompiledCNN` whose methods
only run: ``.forward``, ``.forward_stage`` and ``.serve``. With
``Precision(quant="int8")`` the compile calibrates the model (the JAX
package's precision lifecycle) and the forward runs the int8 pipeline;
with ``Precision(dtype="bfloat16")`` the parameters, activations and
logits are bf16 and the kernels run their bf16 modes.
Entry points run on the CUDA device by default and raise when there is
none, unless the caller passes ``device="cpu"`` (the kernels then run
their plain versions).

What the JAX ``compile_cnn`` also does — the DSE plan tables, dp/pp
placement, artifacts, measured profiles and static verification — is
refused with an error naming the ``ROADMAP.md`` item that will bring it.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core.config import CNNConfig
from repro_torch.models.cnn import CNN, Params, QuantCNN, init_cnn_params
from repro_torch.pipeline.spec import (LATER_ARTIFACTS, LATER_DSE,
                                       LATER_FLEET, LATER_OBS, ExecutionSpec,
                                       refuse)
from repro_torch.quant.calibrate import QuantizedCNNParams, calibrate_cnn

# keyword arguments of the JAX compile_cnn the port does not run yet
_LATER_KWARGS = {"plans": LATER_DSE, "plan_path": LATER_DSE,
                 "measure": LATER_DSE, "measure_opts": LATER_DSE,
                 "trace": LATER_OBS}


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; None means the CUDA device, and
    raises when there is none (the port never falls back to the CPU on
    its own)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the GPU by default; pass "
            "device='cpu' to run the plain versions of its kernels on the "
            "CPU")
    return torch.device("cuda")


class CompiledCNN:
    """A compiled CNN pipeline on one device, fp32, bf16 or int8.

    Construct via :func:`compile_cnn`. ``model`` is the :class:`CNN`
    module (fp32) or the :class:`QuantCNN` module (int8, ``quant`` True)
    holding the parameters on ``device``."""

    def __init__(self, *, cfg: CNNConfig, spec: ExecutionSpec,
                 model: Union[CNN, QuantCNN], device: torch.device):
        self.cfg = cfg
        self.spec = spec
        self.model = model
        self.device = device
        self.engine = None

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def quant(self) -> bool:
        """True when the pipeline runs int8 (a calibrated model)."""
        return isinstance(self.model, QuantCNN)

    @property
    def params(self) -> Union[Params, QuantizedCNNParams]:
        """The fp32 or bf16 parameter list, or the calibrated
        :class:`QuantizedCNNParams` of an int8 pipeline."""
        return self.model.qparams if self.quant else self.model.params

    @property
    def stages(self):
        """One stage per fusion group (no pipeline placement yet)."""
        return tuple((g,) for g in self.model.groups)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def forward(self, x) -> torch.Tensor:
        """x (B, H, W, C) in any float dtype (a tensor or an array) ->
        logits (B, n_classes) on the compiled device. The batch is
        converted to the run dtype first (fp32 for int8, which quantizes
        at the network edge); the logits are bf16 in a bf16 pipeline, else
        fp32."""
        x = torch.as_tensor(x, device=self.device).to(self.model.in_dtype)
        with torch.inference_mode():
            return self.model(x.contiguous())

    def forward_stage(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Run compiled stage ``i`` on its boundary activation ``h``: int8
        codes between the groups of an int8 pipeline (the raw fp32 batch
        for stage 0, which quantizes at the network edge), the run dtype
        otherwise (a float ``h`` is converted to it)."""
        if h.is_floating_point():
            h = h.to(self.model.in_dtype)
        with torch.inference_mode():
            return self.model.forward_groups(h.contiguous(), self.stages[i])

    def serve(self, requests: List, *, faults=None, trace=None,
              metrics=None):
        """Drain a request stream; returns the
        :class:`~repro_torch.serve.report.FleetReport`, with the
        per-request completions on ``report.completions``."""
        if faults is not None:
            raise refuse("serve.faults", "fault injection", LATER_FLEET)
        if trace is not None or metrics is not None:
            raise refuse("serve.trace", "trace/metrics export", LATER_OBS)
        if self.engine is None:
            from repro_torch.serve.engine import ServeEngine
            self.engine = ServeEngine.from_spec(self.model, self.spec)
        done, rep = self.engine.serve(requests)
        rep.completions = done
        return rep

    def plans(self):
        raise refuse("CompiledCNN.plans", "plan tables", LATER_DSE)

    def save_plan(self, path: str):
        raise refuse("CompiledCNN.save_plan", "plan tables", LATER_DSE)

    def save(self, path: str):
        raise refuse("CompiledCNN.save", "artifacts", LATER_ARTIFACTS)

    @classmethod
    def load(cls, path: str, **kwargs):
        raise refuse("CompiledCNN.load", "artifacts", LATER_ARTIFACTS)

    def verify(self, *, strict: bool = False):
        raise refuse("CompiledCNN.verify", "static verification", LATER_OBS)

    def __repr__(self) -> str:
        return (f"CompiledCNN({self.cfg.name}, mode={self.mode}, "
                f"dtype={self.spec.precision.dtype}, "
                f"quant={self.spec.precision.quant}, "
                f"batch={self.spec.serving.batch}, "
                f"stages={self.n_stages}, device={self.device}, "
                f"use_kernels={self.spec.use_kernels})")


def compile_cnn(cfg: CNNConfig, spec: Optional[ExecutionSpec] = None,
                params_or_calib=None, *,
                generator: Optional[torch.Generator] = None,
                device=None, **later) -> CompiledCNN:
    """Compile a CNN into a :class:`CompiledCNN`.

    ``params_or_calib`` takes the JAX package's precision lifecycle:

    * ``None`` -- fresh parameters from ``generator`` (default: a CPU
      generator seeded 0);
    * a parameter list (:mod:`repro_torch.models.cnn`; for JAX parameters
      :func:`~repro_torch.models.cnn.params_from_jax`) -- cast to the run
      dtype (``Precision.dtype``), or calibrated here when quantizing;
    * a :class:`~repro_torch.quant.QuantizedCNNParams` -- pre-calibrated
      fixed-point parameters (for JAX ones,
      :func:`~repro_torch.quant.qparams_from_jax`);
    * an fp32 batch (a tensor or an array) -- a calibration batch: fresh
      parameters are calibrated on it (needs ``quant='int8'``);
    * ``(params, calib_batch)`` -- an explicit pair for quantization.

    With ``Precision(quant="int8")`` and no batch, the model is calibrated
    on the JAX package's default batch: ``Precision.calib`` standard-normal
    images from ``np.random.default_rng(123)``. ``device`` defaults to the
    CUDA device and raises without one (see :func:`resolve_device`);
    calibration runs there.
    """
    for name in later:
        if name not in _LATER_KWARGS:
            raise TypeError(f"compile_cnn() got an unexpected keyword "
                            f"argument {name!r}")
        raise refuse(f"compile_cnn.{name}", f"compile_cnn({name}=...)",
                     _LATER_KWARGS[name])
    spec = spec if spec is not None else ExecutionSpec()
    quantize = spec.precision.quant == "int8"

    params, calib = params_or_calib, None
    if isinstance(params_or_calib, tuple):
        params, calib = params_or_calib
    elif params_or_calib is not None and hasattr(params_or_calib, "shape"):
        params, calib = None, params_or_calib   # a bare calibration batch
    if calib is not None and not quantize:
        raise ValueError(
            "a calibration batch was provided but "
            "spec.precision.quant='none' — set quant='int8' or drop the "
            "batch")
    if isinstance(params, QuantizedCNNParams) and not quantize:
        raise ValueError(
            "params are QuantizedCNNParams but spec.precision.quant="
            "'none' — compile with Precision(quant='int8')")
    dev = resolve_device(device)
    dtype = getattr(torch, spec.precision.dtype)
    if params is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = init_cnn_params(cfg, generator=generator, device=dev,
                                 dtype=dtype)
    if not quantize:
        params = [None if p is None else
                  {k: v.to(dtype=dtype) for k, v in p.items()}
                  for p in params]
        model = CNN(cfg, params, use_kernels=spec.use_kernels)
    else:
        if not isinstance(params, QuantizedCNNParams):
            if calib is None:
                # the serving default: a deterministic synthetic batch
                # from the request distribution, as the JAX compile draws it
                calib = np.random.default_rng(123).standard_normal(
                    (spec.precision.calib, cfg.input_hw, cfg.input_hw,
                     cfg.input_ch)).astype(np.float32)
            params = calibrate_cnn(
                [None if p is None else {k: v.to(dev) for k, v in p.items()}
                 for p in params], calib, cfg)
        model = QuantCNN(cfg, params, use_kernels=spec.use_kernels)
    return CompiledCNN(cfg=cfg, spec=spec, model=model.to(dev).eval(),
                       device=dev)
