"""compile_cnn: the compile phase of the port's pipeline.

``compile_cnn(cfg, spec)`` resolves the parameters, the device and the
spec into an immutable :class:`CompiledCNN` whose methods only run:
``.forward``, ``.forward_stage`` and ``.serve``. Entry points run on the
CUDA device by default and raise when there is none, unless the caller
passes ``device="cpu"`` (the kernels then run their plain versions).

What the JAX ``compile_cnn`` also does — the DSE plan tables, int8
calibration, dp/pp placement, artifacts, measured profiles and static
verification — is refused with an error naming the ``ROADMAP.md`` item
that will bring it.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.core.config import CNNConfig
from repro_torch.models.cnn import CNN, Params, init_cnn_params
from repro_torch.pipeline.spec import (LATER_ARTIFACTS, LATER_DSE,
                                       LATER_FLEET, LATER_OBS, ExecutionSpec,
                                       refuse)

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
    """A compiled fp32 CNN pipeline on one device.

    Construct via :func:`compile_cnn`. ``model`` is the :class:`CNN`
    module holding the parameters on ``device``."""

    def __init__(self, *, cfg: CNNConfig, spec: ExecutionSpec, model: CNN,
                 device: torch.device):
        self.cfg = cfg
        self.spec = spec
        self.model = model
        self.device = device
        self.engine = None

    @property
    def mode(self) -> str:
        return self.spec.mode

    @property
    def params(self) -> Params:
        return self.model.params

    @property
    def stages(self):
        """One stage per fusion group (no pipeline placement yet)."""
        return tuple((g,) for g in self.model.groups)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def forward(self, x) -> torch.Tensor:
        """x (B, H, W, C) fp32 (a tensor or an array) -> logits (B, n_classes)
        on the compiled device."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self.model(x.contiguous())

    def forward_stage(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Run compiled stage ``i`` on its boundary activation ``h``."""
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
                f"batch={self.spec.serving.batch}, "
                f"stages={self.n_stages}, device={self.device}, "
                f"use_kernels={self.spec.use_kernels})")


def compile_cnn(cfg: CNNConfig, spec: Optional[ExecutionSpec] = None,
                params: Optional[Params] = None, *,
                generator: Optional[torch.Generator] = None,
                device=None, **later) -> CompiledCNN:
    """Compile a CNN into a :class:`CompiledCNN`.

    ``params`` is the per-layer list of :mod:`repro_torch.models.cnn`
    (for JAX parameters, :func:`~repro_torch.models.cnn.params_from_jax`);
    None draws fresh ones from ``generator`` (default: a CPU generator
    seeded 0). ``device`` defaults to the CUDA device and raises without
    one (see :func:`resolve_device`).
    """
    for name in later:
        if name not in _LATER_KWARGS:
            raise TypeError(f"compile_cnn() got an unexpected keyword "
                            f"argument {name!r}")
        raise refuse(f"compile_cnn.{name}", f"compile_cnn({name}=...)",
                     _LATER_KWARGS[name])
    spec = spec if spec is not None else ExecutionSpec()
    dev = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = init_cnn_params(cfg, generator=generator, device=dev)
    model = CNN(cfg, params, use_kernels=spec.use_kernels).to(dev).eval()
    return CompiledCNN(cfg=cfg, spec=spec, model=model, device=dev)
