"""The static plan and artifact verifier of the port.

PipeCNN's design flow proves a configuration fits the FPGA before
synthesis. The JAX package's ``analysis/plans.py`` re-proves its Pallas
plans against the TPU's VMEM; this module re-proves the port's plans
against what its CUDA kernels check at launch, from a committed
:class:`~repro_torch.pipeline.plan_table.PlanTable` (with the spec and
config it was compiled under, or a whole ``CompiledCNN.save`` artifact),
without running a kernel or looking up a plan:

* a row's backend is the port's (``cuda:sm_<cc>:<sms>``); a JAX table's
  ``"tpu"`` row, whose Pallas blocking no CUDA kernel takes, is a finding
  (RPA304), never a silent pass;
* a tile's or split's shared memory (the kernels' table,
  ``conv_pipe.CONV_SMEM`` / ``matmul_pipe.FC_SMEM``) fits the row's
  budget and the card's opt-in limit a block (RPA301), and the row's
  recorded ``smem_bytes`` is that table's (RPA302);
* a ``(tp, tn, tph, tpw)`` tile is instantiated and its pooled patch fits
  its rows and the layer's pooled map, and a ``(tnf, ranks)`` split is
  instantiated with 1 to 8 ranks, at most one a chunk of K: the wrappers'
  own ``tile_problem`` / ``split_problem`` (RPA303);
* rows are keyed at the spec's run dtype and budget, and an artifact's
  parameters are int8 codes exactly when the spec quantizes (RPA304);
* the fusion groups partition the layers, every group has one plan at
  the serving key, and the stages cover every group once (RPA305);
* format-3 ``measured`` records join their rows and carry the card's
  fingerprint (RPA306);
* an artifact is whole: commit marker, manifest, a config and spec that
  rebuild, leaf files present (RPA307).

Only pure functions are called: ``autotune.sweep_stats`` and
``measure_stats`` are unchanged by a verification.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.core.config import CNNConfig, SpecError, fuse_groups
from repro_torch.core.roofline import profile_for
from repro_torch.kernels import conv_pipe as cp
from repro_torch.kernels import matmul_pipe as mp
from repro_torch.kernels.autotune import (_DTYPES, ConvPlan, ConvShape,
                                          GemmPlan, GemmShape,
                                          conv_smem_bytes, gemm_smem_bytes,
                                          is_port_backend)

_ROW_FIELDS = ("shape", "backend", "vmem_budget", "plan")
# no budget: the wrappers' checks then report geometry alone
_UNBOUNDED = 1 << 62


def _row(table, kind: str, i: int, path: str,
         shape_cls, plan_cls, findings: List[Finding]):
    """Decode row ``i`` of a port backend, or record the finding (RPA300
    malformed, RPA304 another backend's) and return None."""
    row = (table.conv if kind == "conv" else table.gemm)[i]
    loc = f"{path}#{kind}[{i}]"
    missing = [f for f in _ROW_FIELDS if f not in row]
    if missing:
        findings.append(Finding(
            "RPA300", loc, 0,
            f"plan row is missing field(s) {missing}: not a "
            f"registry-snapshot record"))
        return None
    if not is_port_backend(row["backend"]):
        findings.append(Finding(
            "RPA304", loc, 0,
            f"backend {row['backend']!r} is not the port's "
            f"(cuda:sm_<cc>:<sms>): no CUDA kernel takes its plan "
            f"{row['plan']}"))
        return None
    try:
        shape = shape_cls(**row["shape"])
        plan = plan_cls(**row["plan"])
        limit = profile_for(row["backend"]).smem_per_block
    except (TypeError, ValueError) as e:
        findings.append(Finding(
            "RPA300", loc, 0, f"plan row does not decode as "
            f"({shape_cls.__name__}, {plan_cls.__name__}) on "
            f"{row['backend']!r}: {e}"))
        return None
    if not isinstance(row["vmem_budget"], int) or row["vmem_budget"] <= 0:
        findings.append(Finding(
            "RPA300", loc, 0,
            f"vmem_budget={row['vmem_budget']!r} is not a positive "
            f"byte count"))
        return None
    if shape.dtype not in _DTYPES:
        findings.append(Finding(
            "RPA304", loc, 0,
            f"shape dtype {shape.dtype!r} is not a kernel mode "
            f"({sorted(_DTYPES)})"))
        return None
    return loc, row, shape, plan, limit


def _check_smem(loc: str, row: dict, what: str, need: int, limit: int,
                recorded: int, findings: List[Finding]) -> None:
    """RPA301: the kernel's shared memory over the row's budget or the
    card's opt-in limit; else RPA302: a recorded figure that is not the
    kernels' table's."""
    budget = min(row["vmem_budget"], limit)
    if need > budget:
        findings.append(Finding(
            "RPA301", loc, 0,
            f"{what} for shape {row['shape']} needs {need} B of shared "
            f"memory a block > budget {budget} B (declared "
            f"{row['vmem_budget']} B, the card's opt-in limit {limit} B)"))
    elif recorded and recorded != need:
        findings.append(Finding(
            "RPA302", loc, 0,
            f"recorded smem_bytes={recorded} disagrees with the kernels' "
            f"table ({need} B): the row was edited or the table changed "
            f"under it"))


def _check_conv_row(loc: str, row: dict, shape: ConvShape, plan: ConvPlan,
                    limit: int, spec, findings: List[Finding]) -> None:
    dt = _DTYPES[shape.dtype]
    cg = shape.c // shape.groups
    problem = cp.tile_problem(plan.tile, dt, cg, shape.ph, shape.pw,
                              shape.pool, shape.pool_k, shape.pool_s,
                              _UNBOUNDED)
    if problem is not None:
        findings.append(Finding(
            "RPA303", loc, 0,
            f"conv tile {plan.tile} does not fit the layer {row['shape']}: "
            f"{problem}"))
    else:
        _check_smem(loc, row, f"conv tile {plan.tp}x{plan.tn}",
                    conv_smem_bytes(shape, plan.tp, plan.tn), limit,
                    plan.smem_bytes, findings)
    _check_spec_key(loc, row, shape.dtype, spec, findings)


def _check_gemm_row(loc: str, row: dict, shape: GemmShape, plan: GemmPlan,
                    limit: int, spec, findings: List[Finding]) -> None:
    dt = _DTYPES[shape.dtype]
    problem = mp.split_problem(plan.split, dt, shape.k, _UNBOUNDED)
    if problem is not None:
        findings.append(Finding(
            "RPA303", loc, 0,
            f"FC split {plan.split} does not fit the layer "
            f"{row['shape']}: {problem}"))
    else:
        _check_smem(loc, row, f"FC split {plan.tnf}f x {plan.ranks}r",
                    gemm_smem_bytes(shape, plan.tnf), limit,
                    plan.smem_bytes, findings)
    _check_spec_key(loc, row, shape.dtype, spec, findings)


def _check_spec_key(loc: str, row: dict, dtype: str, spec,
                    findings: List[Finding]) -> None:
    """Rows of a compiled artifact are keyed at the spec's (dtype,
    budget): int8 specs get int8 plans, fp32 specs do not."""
    if spec is None:
        return
    if dtype != spec.run_dtype:
        findings.append(Finding(
            "RPA304", loc, 0,
            f"plan tuned for dtype {dtype!r} but the Precision spec "
            f"runs {spec.run_dtype!r} (quant={spec.precision.quant!r})"))
    if row["vmem_budget"] != spec.tiling.vmem_budget:
        findings.append(Finding(
            "RPA304", loc, 0,
            f"plan tuned under vmem_budget={row['vmem_budget']} but "
            f"Tiling.vmem_budget={spec.tiling.vmem_budget}"))


def _check_measured(table, path: str, findings: List[Finding]) -> None:
    """Format-3 reconciliation: each measured record joins its row by
    ``plan_key`` unambiguously, and a measured table says which card the
    numbers came from."""
    from repro_torch.pipeline.plan_table import plan_key

    by_key = {}
    n_measured = 0
    for kind in ("conv", "gemm"):
        for i, row in enumerate(getattr(table, kind)):
            if not all(f in row for f in _ROW_FIELDS):
                continue        # already RPA300
            loc = f"{path}#{kind}[{i}]"
            measured = row.get("measured")
            if measured is None and "measured" in row:
                measured = {}   # present-but-null is malformed too
            if measured is not None:
                n_measured += 1
                t = measured.get("t_measured") if isinstance(measured, dict) \
                    else None
                if not isinstance(t, (int, float)) or t <= 0:
                    findings.append(Finding(
                        "RPA306", loc, 0,
                        f"measured record carries no positive t_measured "
                        f"(got {measured!r})"))
            key = plan_key(row)
            prev = by_key.setdefault(key, (loc, measured))
            if prev[1] is not None and measured is not None \
                    and prev[1] != measured:
                findings.append(Finding(
                    "RPA306", loc, 0,
                    f"two rows share plan_key but carry different "
                    f"measured records (see {prev[0]}): the measurement "
                    f"join is ambiguous"))
    if n_measured and table.provenance \
            and "measurement" not in table.provenance:
        findings.append(Finding(
            "RPA306", path, 0,
            f"{n_measured} measured row(s) but "
            f"provenance['measurement'] (backend fingerprint) is "
            f"missing: the numbers cannot be attributed to a card"))


def _check_coverage(table, cfg: CNNConfig, spec, path: str,
                    findings: List[Finding]) -> None:
    """The fusion groups partition the layers, and every conv and fc
    group has exactly one plan at the serving (batch, dtype, budget)
    key."""
    from repro_torch.pipeline.compile import _group_shapes

    groups = fuse_groups(cfg.layers)
    flat = [i for g in groups for i in g]
    if sorted(flat) != list(range(len(cfg.layers))):
        findings.append(Finding(
            "RPA305", path, 0,
            f"fuse_groups does not partition the {len(cfg.layers)} "
            f"layers: covered indices {sorted(flat)}"))
        return
    if not (spec.use_kernels and spec.tiling.autotune):
        return      # the oracles / manual tiling: no table contract
    budget = spec.tiling.vmem_budget
    index = {}
    for kind in ("conv", "gemm"):
        for row in getattr(table, kind):
            if not all(f in row for f in _ROW_FIELDS):
                continue
            k = (json.dumps(row["shape"], sort_keys=True),
                 row["vmem_budget"])
            index.setdefault(k, []).append(
                json.dumps(row["plan"], sort_keys=True))
    for group, kind, shape in _group_shapes(cfg, spec.serving.batch,
                                            spec.run_dtype):
        k = (json.dumps(dataclasses.asdict(shape), sort_keys=True), budget)
        plans = index.get(k, [])
        if not plans:
            findings.append(Finding(
                "RPA305", path, 0,
                f"fusion group {tuple(group)} ({kind}, "
                f"{dataclasses.asdict(shape)}) has no plan row at the "
                f"serving key (batch={spec.serving.batch}, "
                f"dtype={spec.run_dtype!r}, budget={budget})"))
        elif len(set(plans)) > 1:
            findings.append(Finding(
                "RPA305", path, 0,
                f"fusion group {tuple(group)} has {len(set(plans))} "
                f"distinct plans for one tuning key: seeding from this "
                f"table is ambiguous"))


def verify_plan_table(table, *, spec=None, cfg: Optional[CNNConfig] = None,
                      path: str = "plan_table") -> List[Finding]:
    """Statically verify one :class:`PlanTable`.

    ``spec``/``cfg`` add the spec-consistency and coverage checks; a bare
    table still gets the backend, shared-memory, geometry and measurement
    checks. ``path`` is the findings' locator prefix."""
    findings: List[Finding] = []
    for kind, shape_cls, plan_cls, check in (
            ("conv", ConvShape, ConvPlan, _check_conv_row),
            ("gemm", GemmShape, GemmPlan, _check_gemm_row)):
        for i in range(len(getattr(table, kind))):
            dec = _row(table, kind, i, path, shape_cls, plan_cls, findings)
            if dec is not None:
                check(*dec, spec, findings)
    _check_measured(table, path, findings)
    if cfg is not None and spec is not None:
        _check_coverage(table, cfg, spec, path, findings)
    return findings


def verify_artifact(path) -> List[Finding]:
    """Statically verify a ``CompiledCNN.save`` artifact directory (the
    port's or the JAX package's). Pure reads: nothing is compiled and no
    kernel runs. A rejected spec surfaces its :class:`SpecError` text, so
    the finding reads as the constructor's rejection would."""
    from repro_torch.pipeline.artifact import cfg_from_dict, spec_from_dict
    from repro_torch.pipeline.plan_table import PlanTable

    root = Path(path)
    loc = str(root)
    findings: List[Finding] = []
    if not root.is_dir():
        return [Finding("RPA307", loc, 0, "not a directory")]
    if not (root / "_COMMITTED").exists():
        findings.append(Finding(
            "RPA307", loc, 0,
            "no _COMMITTED marker: a crashed save, or not an artifact "
            "directory"))
    man_path = root / "manifest.json"
    if not man_path.exists():
        findings.append(Finding("RPA307", loc, 0, "manifest.json missing"))
        return findings
    try:
        manifest = json.loads(man_path.read_text())
    except ValueError as e:
        findings.append(Finding(
            "RPA307", loc, 0, f"manifest.json is not JSON: {e}"))
        return findings
    if manifest.get("format") != 1:
        findings.append(Finding(
            "RPA307", loc, 0,
            f"manifest format {manifest.get('format')!r}, this verifier "
            f"understands 1"))
        return findings
    cfg = spec = None
    try:
        cfg = cfg_from_dict(manifest["cfg"])
        spec = spec_from_dict(manifest["spec"])
    except SpecError as e:
        findings.append(Finding(
            "RPA307", loc, 0, f"manifest rejects reconstruction "
            f"({e.field}): {e}"))
    except (KeyError, TypeError, ValueError) as e:
        findings.append(Finding(
            "RPA307", loc, 0, f"manifest cfg/spec does not reconstruct: "
            f"{e!r}"))
    findings.extend(_check_params_manifest(
        root, manifest.get("params"), spec, loc))
    table_path = root / "plan_table.json"
    if not table_path.exists():
        findings.append(Finding(
            "RPA307", loc, 0, "plan_table.json missing"))
        return findings
    try:
        table = PlanTable.from_json(table_path.read_text())
    except ValueError as e:
        findings.append(Finding(
            "RPA307", str(table_path), 0, f"plan table rejected: {e}"))
        return findings
    findings.extend(verify_plan_table(table, spec=spec, cfg=cfg,
                                      path=str(table_path)))
    return findings


def _check_params_manifest(root: Path, pman, spec,
                           loc: str) -> List[Finding]:
    findings: List[Finding] = []
    if not isinstance(pman, dict) or "leaves" not in pman \
            or "layers" not in pman:
        findings.append(Finding(
            "RPA307", loc, 0,
            "params manifest missing (no layers/leaves record)"))
        return findings
    fmt = pman.get("format")
    if fmt not in ("fp32", "int8"):
        findings.append(Finding(
            "RPA307", loc, 0, f"params format {fmt!r}: fp32 or int8"))
        return findings
    if spec is not None:
        want = "int8" if spec.precision.quant == "int8" else "fp32"
        if fmt != want:
            findings.append(Finding(
                "RPA304", loc, 0,
                f"params are {fmt} but Precision.quant="
                f"{spec.precision.quant!r} compiles a {want} pipeline"))
    n_leaves = len(pman["leaves"])
    used: List[int] = []
    for i, layer in enumerate(pman["layers"]):
        if layer is None:
            continue
        if fmt == "int8":
            arrays = layer.get("arrays", {})
            used.extend(v for v in arrays.values() if v is not None)
            # weightless quantized layers (pool/lrn) carry all-null
            # arrays by design; only weighted kinds need int8 codes
            if layer.get("kind") in ("conv", "fc") \
                    and arrays.get("w_q") is None:
                findings.append(Finding(
                    "RPA304", loc, 0,
                    f"int8 layer {i} carries no quantized weight "
                    f"(arrays.w_q is null): a fixed-point pipeline "
                    f"needs int8 codes and requantize scales"))
        else:
            used.extend(v for v in (layer.get("w"), layer.get("b"))
                        if v is not None)
    bad = sorted(v for v in used if not isinstance(v, int)
                 or not 0 <= v < n_leaves)
    if bad:
        findings.append(Finding(
            "RPA307", loc, 0,
            f"leaf indices {bad} outside the {n_leaves} recorded leaves"))
    missing = sorted(i for i in set(used) - set(bad)
                     if not (root / f"leaf_{i}.npy").exists())
    if missing:
        findings.append(Finding(
            "RPA307", loc, 0,
            f"leaf file(s) missing on disk: "
            f"{[f'leaf_{i}.npy' for i in missing]}"))
    return findings


def verify_compiled(compiled) -> List[Finding]:
    """Verify a live ``CompiledCNN`` (``CompiledCNN.verify()`` calls
    this): its plan table against its own spec and config, and its stages
    covering every fusion group exactly once."""
    findings = verify_plan_table(compiled.plans(), spec=compiled.spec,
                                 cfg=compiled.cfg,
                                 path=f"compiled:{compiled.cfg.name}")
    staged = [tuple(g) for stage in compiled.stages for g in stage]
    want = [tuple(g) for g in fuse_groups(compiled.cfg.layers)]
    if sorted(staged) != sorted(want) or len(staged) != len(want):
        findings.append(Finding(
            "RPA305", f"compiled:{compiled.cfg.name}", 0,
            f"stage plan does not cover every fusion group exactly "
            f"once: staged {staged} vs groups {want}"))
    return findings
