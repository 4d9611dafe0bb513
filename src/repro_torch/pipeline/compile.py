"""compile_cnn: the compile phase of the port's pipeline.

``compile_cnn(cfg, spec)`` resolves the parameters, the precision, the
device, the spec and every kernel plan into an immutable
:class:`CompiledCNN` whose methods only run: ``.forward``,
``.forward_stage`` and ``.serve``. With ``Precision(quant="int8")`` the
compile calibrates the model (the JAX package's precision lifecycle) and
the forward runs the int8 pipeline; with ``Precision(dtype="bfloat16")``
the parameters, activations and logits are bf16 and the kernels run
their bf16 modes. The DSE (:mod:`repro_torch.kernels.autotune`) resolves
one plan a conv and FC group at the serving batch; the forward launches
each group with its plan, and the plans freeze into a
:class:`~repro_torch.pipeline.plan_table.PlanTable` (``save_plan``; a
later ``compile_cnn(plan_path=...)`` runs no sweep; ``measure=True``
times every plan on the card). Entry points run on the CUDA device by
default and raise when there is none, unless the caller passes
``device="cpu"`` (the kernels then run their plain versions).

What the JAX ``compile_cnn`` also does — dp/pp placement, artifacts,
compile traces and static verification — is refused with an error naming
the ``ROADMAP.md`` item that will bring it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import CNNConfig
from repro_torch.core.roofline import device_profile, profile_for
from repro_torch.kernels import autotune
from repro_torch.models.cnn import CNN, Params, QuantCNN, init_cnn_params
from repro_torch.pipeline.plan_table import PlanTable, load_plan, plan_key
from repro_torch.pipeline.spec import (LATER_ARTIFACTS, LATER_FLEET,
                                       LATER_OBS, ExecutionSpec, refuse)
from repro_torch.quant.calibrate import QuantizedCNNParams, calibrate_cnn


def _group_shapes(cfg: CNNConfig, batch: int, dtype: str):
    """Yield ``(group, kind, shape)``, the DSE key of every conv(+pool)
    (``"conv"``, a ``ConvShape``) and fc (``"gemm"``, a ``GemmShape``)
    group at (batch, dtype): one constructor for the plan resolve and the
    roofline breakdown."""
    from repro_torch.serve.stage_planner import group_io_shapes, group_shape
    for group, in_shape, out_shape in group_io_shapes(cfg):
        shape = group_shape(cfg, group, in_shape, out_shape, batch, dtype)
        if shape is not None:
            yield group, ("conv" if isinstance(shape, autotune.ConvShape)
                          else "gemm"), shape


def _resolve_group_plans(cfg: CNNConfig, batch: int, dtype: str, *,
                         vmem_budget: int, backend: str
                         ) -> Dict[Tuple[int, ...], Any]:
    """One registry lookup a conv and fc group at (batch, dtype): the
    frozen plans ``CompiledCNN.forward`` launches with. A plan that does
    not fit (a seeded table's, under this budget) raises: it is never
    replaced by another."""
    plans: Dict[Tuple[int, ...], Any] = {}
    for group, kind, shape in _group_shapes(cfg, batch, dtype):
        if kind == "conv":
            plan = autotune.get_plan(shape, vmem_budget=vmem_budget,
                                     backend=backend)
            fits = autotune.plan_fits(shape, plan, vmem_budget)
        else:
            plan = autotune.get_gemm_plan(shape, vmem_budget=vmem_budget,
                                          backend=backend)
            fits = autotune.gemm_plan_fits(shape, plan, vmem_budget)
        if not fits:
            raise ValueError(
                f"the plan {plan} of group {group} ({shape}) does not fit "
                f"its kernel under {vmem_budget} B of shared memory a block")
        plans[group] = plan
    return plans


def _manual_plans(cfg: CNNConfig, batch: int, dtype: str, tn: int, *,
                  vmem_budget: int, backend: str
                  ) -> Dict[Tuple[int, ...], Any]:
    """``Tiling(autotune=False, cu_num=tn)``: every conv group at ``tn``
    channels (no registry lookup, no table row); fc groups keep the
    kernel's rule."""
    return {group: autotune.manual_plan(shape, tn, vmem_budget,
                                        backend=backend)
            for group, kind, shape in _group_shapes(cfg, batch, dtype)
            if kind == "conv"}


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
    holding the parameters on ``device`` and folding over
    ``group_plans``, the frozen plan of each conv and fc group;
    ``plan_table`` is every plan the compile looked up, as data."""

    def __init__(self, *, cfg: CNNConfig, spec: ExecutionSpec,
                 model: Union[CNN, QuantCNN], device: torch.device,
                 group_plans: Optional[Dict[Tuple[int, ...], Any]] = None,
                 plan_table: Optional[PlanTable] = None,
                 backend: Optional[str] = None):
        self.cfg = cfg
        self.spec = spec
        self.model = model
        self.device = device
        self.group_plans = dict(group_plans or {})
        self.plan_table = plan_table if plan_table is not None \
            else PlanTable()
        self.backend = backend or device_profile(device).tag
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

    def roofline_breakdown(self) -> List[dict]:
        """One row a conv and fc group at the compiled serving batch: its
        layers, kind, plan, the compute and memory terms of the cost model
        (seconds for the batch), their max ``t_model`` and which binds;
        with a measured table, ``t_measured`` (seconds a call) and
        ``drift`` (measured / modelled), else None."""
        batch = self.spec.serving.batch
        budget = self.spec.tiling.vmem_budget
        prof = profile_for(self.backend)
        measured = self.plan_table.measurements()
        rows: List[dict] = []
        for group, kind, shape in _group_shapes(
                self.cfg, batch, self.spec.run_dtype):
            plan = self.group_plans.get(group)
            if kind == "conv":
                if plan is None:
                    plan = autotune.rule_plan(shape, backend=self.backend)
                tc, tm = autotune.score_plan(shape, *plan.tile, profile=prof)
                tc, tm = tc * batch, tm * batch
            else:
                if plan is None:
                    plan = autotune.rule_gemm_plan(shape,
                                                   backend=self.backend)
                tc, tm = autotune.score_gemm_plan(shape, *plan.split,
                                                  profile=prof)
            t_model = max(tc, tm)
            m = measured.get(plan_key(
                {"shape": dataclasses.asdict(shape), "backend": self.backend,
                 "vmem_budget": budget, "plan": plan.to_dict()}))
            rows.append({"group": list(group), "kind": kind,
                         "plan": plan.to_dict(),
                         "t_compute": tc, "t_memory": tm,
                         "t_model": t_model,
                         "bound": "compute" if tc >= tm else "memory",
                         "t_measured": m["t_measured"] if m else None,
                         "drift": (m["t_measured"] / t_model
                                   if m and t_model > 0 else None)})
        return rows

    def plans(self) -> PlanTable:
        """Every plan this compile resolved, as serialisable data."""
        return self.plan_table

    def save_plan(self, path: str) -> str:
        """Write the plan table as canonical JSON (byte-stable across
        save/load); ``compile_cnn(..., plan_path=path)`` then runs no
        sweep."""
        return self.plan_table.save(path)

    load_plan = staticmethod(load_plan)

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
                f"use_kernels={self.spec.use_kernels}, "
                f"plans={self.plan_table.summary()})")


def compile_cnn(cfg: CNNConfig, spec: Optional[ExecutionSpec] = None,
                params_or_calib=None, *,
                plans: Optional[PlanTable] = None,
                plan_path: Optional[str] = None,
                measure: bool = False, measure_opts=None,
                generator: Optional[torch.Generator] = None,
                device=None, trace=None) -> CompiledCNN:
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

    With ``Tiling(autotune=True)`` (the default) every conv and fc group
    gets its plan from the registry at the serving batch, on the device's
    backend tag: the kernels' measured rules, so the default plans launch
    the tiles a launch without a plan would. ``plans`` / ``plan_path``
    seed the registry from a saved table first: the compile then runs no
    sweep, and its table carries the seed's provenance and measurements
    verbatim (it measures nothing, even with ``measure=True``).
    ``measure=True`` on an unseeded compile times every plan on the card
    (``repro_torch.obs.profiler.profile_table`` under ``measure_opts``, a
    ``MeasureOptions``) and returns a format-3 table.
    """
    if trace is not None:
        raise refuse("compile_cnn.trace", "compile_cnn(trace=...)",
                      LATER_OBS)
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
    backend = device_profile(dev).tag
    budget = spec.tiling.vmem_budget
    if plan_path is not None:
        plans = PlanTable.load(plan_path)
    if plans is not None:
        plans.seed()
    dtype = getattr(torch, spec.precision.dtype)
    if params is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = init_cnn_params(cfg, generator=generator, device=dev,
                                 dtype=dtype)
    if quantize and not isinstance(params, QuantizedCNNParams):
        if calib is None:
            # the serving default: a deterministic synthetic batch from
            # the request distribution, as the JAX compile draws it
            calib = np.random.default_rng(123).standard_normal(
                (spec.precision.calib, cfg.input_hw, cfg.input_hw,
                 cfg.input_ch)).astype(np.float32)
        params = calibrate_cnn(
            [None if p is None else {k: v.to(dev) for k, v in p.items()}
             for p in params], calib, cfg)

    sweeps_before = autotune.sweep_stats()
    group_plans: Dict[Tuple[int, ...], Any] = {}
    with autotune.record_lookups() as rec:
        if spec.use_kernels and spec.tiling.autotune:
            group_plans = _resolve_group_plans(
                cfg, spec.serving.batch, spec.run_dtype,
                vmem_budget=budget, backend=backend)
        elif spec.use_kernels and spec.tiling.cu_num:
            group_plans = _manual_plans(
                cfg, spec.serving.batch, spec.run_dtype, spec.tiling.cu_num,
                vmem_budget=budget, backend=backend)
    sweeps_after = autotune.sweep_stats()
    if plans is not None:
        # a seeded compile re-captures the same plans: carry the seed's
        # provenance and measurements verbatim, so save -> load -> compile
        # -> save is byte-identical; nothing is measured
        table = PlanTable.from_rows(
            rec["conv"], rec["gemm"],
            provenance=plans.provenance).with_measurements(
                plans.measurements())
    else:
        table = PlanTable.from_rows(rec["conv"], rec["gemm"], provenance={
            "sweep_stats": {k: sweeps_after[k] - sweeps_before[k]
                            for k in sorted(sweeps_after)},
            "lookups": {"conv": len(rec["conv"]), "gemm": len(rec["gemm"])}})
        if measure:
            from repro_torch.obs.profiler import profile_table
            table = profile_table(table, opts=measure_opts, device=dev)

    if not quantize:
        params = [None if p is None else
                  {k: v.to(dtype=dtype) for k, v in p.items()}
                  for p in params]
        model = CNN(cfg, params, use_kernels=spec.use_kernels,
                    plans=group_plans)
    else:
        model = QuantCNN(cfg, params, use_kernels=spec.use_kernels,
                         plans=group_plans)
    return CompiledCNN(cfg=cfg, spec=spec, model=model.to(dev).eval(),
                       device=dev, group_plans=group_plans,
                       plan_table=table, backend=backend)
