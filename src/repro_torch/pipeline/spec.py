"""ExecutionSpec: the compile-time contract of the port's pipeline.

The same sub-specs and field names as the JAX package's
``pipeline/spec.py`` — :class:`Precision`, :class:`Tiling`,
:class:`Placement`, :class:`Serving` — validated at construction. The port
runs fp32, bf16 or calibrated int8, with per-layer plans from the DSE
(:mod:`repro_torch.kernels.autotune`), placed as one replica or as dp
replicas, pp stages or both on one card, and serves gang rounds on the
measured or the modelled clock, or continuous slots with work stealing
and autoscaling on the modelled one, with retries and backoff under
replica faults. Each manual tiling knob the CUDA kernels have no axis for
is refused with a :class:`SpecError` naming the field.
:func:`spec_from_config` and :func:`resolve_config` are the JAX package's
deprecated bridges to its knob-carrying ``CNNConfig``.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.config import CNNConfig, SpecError
from repro_torch.core.roofline import H100
from repro_torch.serve.scheduler import AutoscalePolicy


@dataclass(frozen=True)
class Precision:
    """What numbers flow through the pipeline: fp32, bf16 (``dtype``), or
    int8 codes calibrated on ``calib`` images (fp32 at the boundaries)."""
    dtype: str = "float32"             # float32 | bfloat16
    quant: str = "none"                # none | int8
    calib: int = 8                     # calibration images (int8 only)


@dataclass(frozen=True)
class Tiling:
    """The kernel design space (the paper's Fig. 7 sweep axes), as the CUDA
    kernels take it.

    ``autotune``: each conv and FC group gets its plan from the registry
    (the kernels' measured rules, or a seeded table); False leaves the
    kernels' own rule to each launch, and no plan is recorded.
    ``vmem_budget``: the shared memory a block a plan may request (bytes;
    the JAX field name, the card's counterpart of VMEM), by default the
    H100's opt-in limit, 227 KB. ``cu_num``: the paper's CU_NUM, compute
    units across output channels, maps to the conv tile's channels
    ``tn`` (64 or 128; 0 = the rule's), a manual fallback that applies
    with ``autotune=False`` only, as in the JAX package. ``vec_size``,
    ``oh_blk`` and ``b_blk`` have no CUDA axis and are refused when set:
    each kernel's reduction chunk is fixed by its instantiation, its rows
    are a flat position tile (no line buffer), and a tile spans the batch
    (no images-per-step fold).
    """
    autotune: bool = True
    vmem_budget: int = H100.smem_per_block
    vec_size: int = 0
    cu_num: int = 0
    oh_blk: int = 0
    b_blk: int = 1


@dataclass(frozen=True)
class Placement:
    """Where the pipeline runs: ``replicas`` data-parallel replicas of
    ``pp_stages`` pipeline stages, each a CUDA stream of the one card (the
    JAX package's devices of a (data, pipe) mesh); ``microbatches`` is
    GPipe's M a round (0: the modelled round's best divisor of the
    batch)."""
    replicas: int = 1
    pp_stages: int = 1
    microbatches: int = 0


@dataclass(frozen=True)
class Serving:
    """The request loop around the compiled forward: gang rounds padded
    to ``batch``, on the ``"measured"`` clock (the round's wall time) or
    the ``"modeled"`` one (the roofline cost model's round time;
    ``execute=False`` then runs nothing on the device). ``max_queue``
    bounds each replica's queue (0 = unbounded); ``slo`` is a latency
    bound the report counts violations of, and the autoscaler's p95
    target (0 = off). Under injected replica faults a lost request
    re-dispatches up to ``retries`` times, ``backoff * 2**(attempt-1)``
    seconds after its loss; past the budget it ends as
    ``Completion(status="failed")``. ``scheduler="continuous"`` (modelled
    clock only) admits and retires requests one by one at microbatch
    boundaries; ``steal_threshold`` > 0 lets a replica steal from a queue
    that many deeper than its own (each steal charges the retry budget);
    ``autoscale`` (an :class:`AutoscalePolicy`) scales the fleet between
    its ``min_replicas`` and ``max_replicas``."""
    batch: int = 8
    max_queue: int = 0
    clock: str = "measured"
    execute: bool = True
    retries: int = 0
    backoff: float = 0.0
    slo: float = 0.0
    scheduler: str = "gang"
    steal_threshold: int = 0
    autoscale: Optional[AutoscalePolicy] = None


@dataclass(frozen=True)
class ExecutionSpec:
    """One immutable description of a compiled pipeline.

    ``use_kernels`` mirrors the JAX package's ``use_pallas``: True runs
    the fused kernels, False the exact oracles."""
    precision: Precision = field(default_factory=Precision)
    tiling: Tiling = field(default_factory=Tiling)
    placement: Placement = field(default_factory=Placement)
    serving: Serving = field(default_factory=Serving)
    use_kernels: bool = True

    def __post_init__(self):
        p, t, pl, s = self.precision, self.tiling, self.placement, \
            self.serving
        if p.dtype not in ("float32", "bfloat16"):
            raise SpecError("Precision.dtype",
                            f"Precision.dtype={p.dtype!r}: float32 or bfloat16")
        if p.quant not in ("none", "int8"):
            raise SpecError("Precision.quant",
                            f"Precision.quant={p.quant!r}: none or int8")
        if p.quant == "int8" and p.dtype != "float32":
            raise SpecError(
                "Precision.quant",
                "Precision.quant='int8' with dtype='bfloat16' is "
                "contradictory: the fixed-point pipeline carries int8 "
                "codes with int32 accumulation; its fp boundary (logits, "
                "LRN detour, calibration) is float32 by construction")
        if p.quant == "int8" and p.calib <= 0:
            raise SpecError(
                "Precision.calib",
                "Precision.quant='int8' needs a calibration source: set "
                "Precision.calib > 0 or hand compile_cnn a calibration "
                "batch / a QuantizedCNNParams")
        if not isinstance(t, Tiling):
            raise SpecError("ExecutionSpec.tiling",
                            f"ExecutionSpec.tiling={t!r}: a Tiling")
        if t.vmem_budget <= 0:
            raise SpecError(
                "Tiling.vmem_budget",
                f"Tiling.vmem_budget={t.vmem_budget}: must "
                "be a positive byte budget")
        if t.vec_size:
            raise SpecError(
                "Tiling.vec_size",
                f"Tiling.vec_size={t.vec_size}: the CUDA kernels have no "
                "VEC_SIZE axis; each instantiation fixes its reduction "
                "chunk (fp32 16, bf16 32, int8 64 or 128 k). Leave it 0")
        if t.oh_blk:
            raise SpecError(
                "Tiling.oh_blk",
                f"Tiling.oh_blk={t.oh_blk}: the CUDA conv has no line "
                "buffer; a block's rows are its tp positions (or a pooled "
                "patch), chosen by the plan. Leave it 0")
        if t.b_blk != 1:
            raise SpecError(
                "Tiling.b_blk",
                f"Tiling.b_blk={t.b_blk}: the CUDA conv has no "
                "images-per-step axis; its position tile runs over the "
                "whole batch. Leave it 1")
        if t.cu_num not in (0, 64, 128):
            raise SpecError(
                "Tiling.cu_num",
                f"Tiling.cu_num={t.cu_num}: the conv tile's channels (tn) "
                "are 64 or 128 (0 = the rule's)")
        if t.cu_num and t.autotune:
            raise SpecError(
                "Tiling.cu_num",
                f"Tiling.cu_num={t.cu_num} with autotune=True is "
                "contradictory: CU_NUM is the manual fallback, as in the "
                "JAX package; set autotune=False to pin tn")
        if pl.replicas < 1 or pl.pp_stages < 1:
            raise SpecError(
                "Placement.replicas",
                f"Placement.replicas={pl.replicas} / "
                f"pp_stages={pl.pp_stages}: both must be >= 1")
        if pl.microbatches:
            if pl.pp_stages == 1:
                raise SpecError(
                    "Placement.microbatches",
                    "Placement.microbatches set without pipeline stages "
                    "(pp_stages=1): GPipe microbatching only exists "
                    "between stages")
            if s.batch % pl.microbatches:
                raise SpecError(
                    "Placement.microbatches",
                    f"Placement.microbatches={pl.microbatches} must "
                    f"divide Serving.batch={s.batch} so every microbatch "
                    f"has one shape")
        if s.batch < 1:
            raise SpecError("Serving.batch",
                            f"Serving.batch={s.batch}: must be >= 1")
        if s.max_queue < 0:
            raise SpecError("Serving.max_queue",
                            f"Serving.max_queue={s.max_queue}: 0 "
                            "(unbounded) or a positive bound")
        if s.clock not in ("measured", "modeled"):
            raise SpecError("Serving.clock",
                            f"Serving.clock={s.clock!r}: measured or modeled")
        if not s.execute and s.clock == "measured":
            raise SpecError(
                "Serving.execute",
                "Serving.execute=False with clock='measured' is "
                "contradictory: a device-free simulation has no wall "
                "time to measure — use clock='modeled'")
        if s.retries < 0:
            raise SpecError(
                "Serving.retries",
                f"Serving.retries={s.retries}: must be >= 0")
        if s.backoff < 0 or s.slo < 0:
            raise SpecError(
                "Serving.backoff",
                f"Serving.backoff={s.backoff} / slo={s.slo}: both are "
                "seconds >= 0")
        if s.backoff and not s.retries:
            raise SpecError(
                "Serving.backoff",
                "Serving.backoff set with retries=0 is contradictory: "
                "backoff only delays re-admission of retried requests")
        if s.scheduler not in ("gang", "continuous"):
            raise SpecError("Serving.scheduler",
                            f"Serving.scheduler={s.scheduler!r}: gang "
                            "or continuous")
        if s.scheduler == "continuous" and s.clock != "modeled":
            raise SpecError(
                "Serving.scheduler",
                "Serving.scheduler='continuous' requires "
                "clock='modeled': slot service and microbatch-boundary "
                "times come from the roofline model, not wall time")
        if s.steal_threshold < 0:
            raise SpecError(
                "Serving.steal_threshold",
                f"Serving.steal_threshold={s.steal_threshold}: 0 "
                "(stealing off) or a positive queue-skew depth")
        if (s.steal_threshold or s.autoscale is not None) and \
                s.scheduler != "continuous":
            raise SpecError(
                "Serving.steal_threshold",
                "Serving.steal_threshold / autoscale only exist under "
                "scheduler='continuous': gang rounds have no "
                "per-request slots to steal or scale")
        if s.autoscale is not None and not isinstance(s.autoscale,
                                                      AutoscalePolicy):
            raise SpecError(
                "Serving.autoscale",
                f"Serving.autoscale={s.autoscale!r}: an AutoscalePolicy")
        if s.autoscale is not None and not (
                s.autoscale.min_replicas <= pl.replicas
                <= s.autoscale.max_replicas):
            raise SpecError(
                "Placement.replicas",
                f"Placement.replicas={pl.replicas} outside the "
                f"autoscale range [{s.autoscale.min_replicas}, "
                f"{s.autoscale.max_replicas}]")

    @property
    def run_dtype(self) -> str:
        """The dtype plans and costs are keyed by ('int8' when quantized)."""
        return "int8" if self.precision.quant == "int8" else \
            self.precision.dtype

    @property
    def mode(self) -> str:
        R, S = self.placement.replicas, self.placement.pp_stages
        return ("single" if R * S == 1 else "dp" if S == 1 else
                "pp" if R == 1 else "hybrid")


def spec_from_config(cfg: CNNConfig, **overrides) -> ExecutionSpec:
    """Deprecated: the JAX package builds the spec from its
    ``CNNConfig``'s legacy knobs, for its old call sites. The port's
    ``CNNConfig`` describes the architecture only, so every knob takes the
    JAX ``CNNConfig``'s default (a serving batch of 64; the budget the
    card's); ``overrides`` replace top-level spec fields or whole
    sub-specs. Build an :class:`ExecutionSpec` instead."""
    warnings.warn("spec_from_config is deprecated: build an ExecutionSpec",
                  DeprecationWarning, stacklevel=2)
    spec = ExecutionSpec(serving=Serving(batch=64))
    return dataclasses.replace(spec, **overrides) if overrides else spec


def resolve_config(cfg: CNNConfig, spec: ExecutionSpec) -> CNNConfig:
    """Deprecated: the JAX package folds a spec's knobs back onto its
    ``CNNConfig``. The port's config carries no knobs (every consumer
    reads the spec), so the architecture comes back as it is; ``spec`` is
    taken for the JAX signature."""
    warnings.warn("resolve_config is deprecated: the port's CNNConfig "
                  "carries no runtime knobs; read the ExecutionSpec",
                  DeprecationWarning, stacklevel=2)
    return cfg
