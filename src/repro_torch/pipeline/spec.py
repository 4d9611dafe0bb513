"""ExecutionSpec: the compile-time contract of the port's pipeline.

The same sub-specs and field names as the JAX package's
``pipeline/spec.py`` — :class:`Precision`, :class:`Tiling`,
:class:`Placement`, :class:`Serving` — validated at construction. The port
runs fp32, bf16 or calibrated int8 on one replica, gang rounds on the
measured or the modelled clock, with per-layer plans from the DSE
(:mod:`repro_torch.kernels.autotune`). Every other value is refused with
a :class:`SpecError` that names the ``ROADMAP.md`` item that will bring
it, and so is each manual tiling knob the CUDA kernels have no axis for.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.config import SpecError
from repro_torch.core.roofline import H100

# what the port does not run yet, and the ROADMAP.md item that brings it
LATER_ARTIFACTS = "ROADMAP.md Queue 1, slice 5 (artifacts)"
LATER_FLEET = ("ROADMAP.md Queue 1, slice 6 (dp/pp placement, with replica "
               "faults, retries and hot_swap)")
LATER_OBS = ("ROADMAP.md Queue 1, slice 7 (continuous scheduling, obs, "
             "profiler, analysis, CLIs and benchmarks)")


def refuse(field_name: str, what: str, later: str) -> SpecError:
    """The error for a knob the port does not run yet."""
    return SpecError(field_name,
                     f"{what} is not in the PyTorch port yet: it comes with "
                     f"{later}")


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
    """Where the pipeline runs (one replica on one card, so far)."""
    replicas: int = 1
    pp_stages: int = 1
    microbatches: int = 0


@dataclass(frozen=True)
class Serving:
    """The request loop around the compiled forward: gang rounds padded
    to ``batch``, on the ``"measured"`` clock (the forward's wall time) or
    the ``"modeled"`` one (the roofline cost model's round time;
    ``execute=False`` then runs nothing on the device). ``max_queue``
    bounds the queue (0 = unbounded); ``slo`` is a latency bound the
    report counts violations of (0 = off)."""
    batch: int = 8
    max_queue: int = 0
    clock: str = "measured"
    execute: bool = True
    retries: int = 0
    backoff: float = 0.0
    slo: float = 0.0
    scheduler: str = "gang"
    steal_threshold: int = 0
    autoscale: Optional[Any] = None


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
        if pl.replicas > 1 or pl.pp_stages > 1 or pl.microbatches:
            raise refuse("Placement.replicas",
                         f"Placement(replicas={pl.replicas}, pp_stages="
                         f"{pl.pp_stages}, microbatches={pl.microbatches})",
                         LATER_FLEET)
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
        if s.retries < 0 or s.backoff < 0 or s.slo < 0:
            raise SpecError(
                "Serving.retries",
                f"Serving.retries={s.retries} / backoff={s.backoff} / "
                f"slo={s.slo}: all must be >= 0")
        if s.retries or s.backoff:
            raise refuse("Serving.retries", "Serving.retries/backoff",
                         LATER_FLEET)
        if s.scheduler not in ("gang", "continuous"):
            raise SpecError("Serving.scheduler",
                            f"Serving.scheduler={s.scheduler!r}: gang "
                            "or continuous")
        if s.scheduler == "continuous":
            raise refuse("Serving.scheduler", "Serving.scheduler="
                         "'continuous'", LATER_OBS)
        if s.steal_threshold or s.autoscale is not None:
            raise refuse("Serving.steal_threshold",
                         "Serving.steal_threshold/autoscale", LATER_OBS)

    @property
    def run_dtype(self) -> str:
        """The dtype plans and costs are keyed by ('int8' when quantized)."""
        return "int8" if self.precision.quant == "int8" else \
            self.precision.dtype

    @property
    def mode(self) -> str:
        return "single"
