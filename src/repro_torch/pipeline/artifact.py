"""The committed serving artifact: one ``CompiledCNN`` as files.

The JAX package's ``pipeline/artifact.py``, in its format (1):

    <dir>/
        manifest.json     - format, cfg, spec, params manifest (per-array
                            leaf index, shape, dtype); canonical JSON
                            (sorted keys, indent 1, trailing newline)
        plan_table.json   - the compile's PlanTable (the port's format 3,
                            backend tag ``cuda:sm_90:132``)
        leaf_<i>.npy      - one file a parameter array
        _COMMITTED        - the commit marker, written last

written under :func:`repro_torch.ckpt.commit_dir`. ``CompiledCNN.load``
rebuilds the pipeline through ``compile_cnn(cfg, spec, params,
plans=table)``: the table seeds the plan registries, so a load runs no
sweep. This artifact is also what the serving fleet's fault model charges
a restoring replica for (``serve.engine.restore_latency_model``).

bf16 leaves are written as their raw 2-byte bits with the ``<V2`` header
``np.save`` gives an ``ml_dtypes`` bfloat16 array (the JAX package's
bytes for the same values), and the manifest says ``"bfloat16"``. Any
2-byte void or integer leaf the manifest calls bfloat16 reads back as
``torch.bfloat16``, so the port reloads its own bf16 artifacts and the JAX
package's. The port never imports ``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (CheckpointError, Leaf, commit_dir,
                                         host_leaf, leaf_tensor, save_leaf)
from repro_torch.core.config import CNNConfig, ConvLayer
from repro_torch.pipeline.plan_table import PlanTable
from repro_torch.pipeline.spec import (AutoscalePolicy, ExecutionSpec,
                                       Placement, Precision, Serving, Tiling)
from repro_torch.quant.calibrate import QuantizedCNNParams, QuantLayer

_FORMAT = 1
# per-QuantLayer array slots, in the fixed on-disk order
_QUANT_ARRAYS = ("w_q", "w_scale", "scale", "b")
_CFG_FIELDS = ("name", "input_hw", "input_ch", "n_classes", "use_lrn")
# the runtime knobs a JAX artifact's cfg also carries; its spec holds the
# same values, and the port keeps them in the spec alone
_JAX_CFG_KNOBS = ("vec_size", "cu_num", "dtype", "quant", "calib", "oh_blk",
                  "autotune", "vmem_budget", "b_blk", "serve_batch",
                  "replicas", "pp_stages", "serve_microbatches", "max_queue")


# -- config / spec <-> plain dicts ------------------------------------------

def _layer_to_dict(l: ConvLayer) -> dict:
    return {"kind": l.kind, "out_ch": l.out_ch, "kernel": l.kernel,
            "stride": l.stride, "pad": l.pad, "groups": l.groups,
            "pool": l.pool, "relu": l.relu, "fuse_pool": None}


def _layer_from_dict(d: dict) -> ConvLayer:
    if d.get("fuse_pool") is not None:
        raise CheckpointError(f"layer {d}: a nested fuse_pool layer has no "
                              f"counterpart in the port's ConvLayer")
    return ConvLayer(kind=d["kind"], out_ch=d["out_ch"], kernel=d["kernel"],
                     stride=d["stride"], pad=d["pad"], groups=d["groups"],
                     pool=d["pool"], relu=d["relu"])


def cfg_to_dict(cfg: CNNConfig) -> dict:
    d = {f: getattr(cfg, f) for f in _CFG_FIELDS}
    d["layers"] = [_layer_to_dict(l) for l in cfg.layers]
    return d


def cfg_from_dict(d: dict) -> CNNConfig:
    """The port's or the JAX package's cfg dict as a ``CNNConfig``; a JAX
    cfg's runtime knobs (``_JAX_CFG_KNOBS``) are dropped."""
    unknown = set(d) - set(_CFG_FIELDS) - set(_JAX_CFG_KNOBS) - {"layers"}
    if unknown:
        raise CheckpointError(f"cfg fields {sorted(unknown)} are neither "
                              f"the port's nor the JAX package's")
    return CNNConfig(layers=tuple(_layer_from_dict(l) for l in d["layers"]),
                     **{f: d[f] for f in _CFG_FIELDS})


def spec_to_dict(spec: ExecutionSpec) -> dict:
    return dataclasses.asdict(spec)


def spec_from_dict(d: dict) -> ExecutionSpec:
    """The port's or the JAX package's spec dict as an ``ExecutionSpec``.

    A JAX spec (it has ``use_pallas``) is read so: ``use_pallas`` becomes
    ``use_kernels``; ``interpret`` is dropped (compiled CUDA kernels have
    no interpret mode); of its ``Tiling`` only ``autotune`` is kept:
    ``vmem_budget`` (VMEM bytes, 16 MiB by default), ``vec_size``,
    ``cu_num``, ``oh_blk`` and ``b_blk`` describe Pallas blockings, so the
    port's defaults stand for them. A nested autoscale policy is rebuilt
    as an :class:`AutoscalePolicy`, so a loaded artifact keeps it."""
    serving = dict(d["serving"])
    if serving.get("autoscale") is not None:
        serving["autoscale"] = AutoscalePolicy(**serving["autoscale"])
    tiling = dict(d["tiling"])
    if "use_pallas" in d:
        tiling = {"autotune": tiling["autotune"]}
        use_kernels = d["use_pallas"]
    else:
        use_kernels = d["use_kernels"]
    return ExecutionSpec(precision=Precision(**d["precision"]),
                         tiling=Tiling(**tiling),
                         placement=Placement(**d["placement"]),
                         serving=Serving(**serving),
                         use_kernels=use_kernels)


# -- params <-> leaf files ---------------------------------------------------

def _params_manifest(params) -> Tuple[dict, List[Leaf]]:
    """Flatten fp32/bf16 params (a per-layer ``{"w", "b"}`` list) or a
    :class:`QuantizedCNNParams` into (manifest dict, ordered leaves), in
    the JAX package's layout: a quantized layer's float scales inline, its
    arrays as leaves in ``_QUANT_ARRAYS`` order."""
    leaves: List[Leaf] = []

    def push(t) -> int:
        leaves.append(host_leaf(t))
        return len(leaves) - 1

    if isinstance(params, QuantizedCNNParams):
        man: dict = {"format": "int8", "in_scale": float(params.in_scale),
                     "layers": []}
        for ql in params.layers:
            if ql is None:
                man["layers"].append(None)
                continue
            man["layers"].append({
                "kind": ql.kind, "x_scale": float(ql.x_scale),
                "y_scale": (None if ql.y_scale is None
                            else float(ql.y_scale)),
                "arrays": {k: (None if getattr(ql, k) is None
                               else push(getattr(ql, k)))
                           for k in _QUANT_ARRAYS}})
    else:
        man = {"format": "fp32", "layers": []}
        for p in params:
            man["layers"].append(None if p is None else
                                 {"w": push(p["w"]), "b": push(p["b"])})
    man["leaves"] = [{"shape": list(a.shape), "dtype": dt}
                     for a, dt in leaves]
    return man, leaves


def _load_leaf(root: Path, i: int, meta: dict) -> torch.Tensor:
    try:
        a = np.load(root / f"leaf_{i}.npy")
    except Exception as e:
        raise CheckpointError(
            f"artifact {root}: leaf {i} (leaf_{i}.npy) is unreadable: "
            f"truncated or corrupt write? ({type(e).__name__}: {e})") from e
    t = leaf_tensor(a, meta["dtype"])
    if list(a.shape) != meta["shape"] or t is None:
        raise CheckpointError(
            f"artifact {root}: leaf {i} is {a.dtype}{tuple(a.shape)} but "
            f"the manifest says {meta['dtype']}{tuple(meta['shape'])}")
    return t


def _params_from_manifest(root: Path, man: dict
                          ) -> Union[list, QuantizedCNNParams]:
    metas = man["leaves"]

    def leaf(i):
        return None if i is None else _load_leaf(root, i, metas[i])

    if man["format"] == "fp32":
        return [None if e is None else {"w": leaf(e["w"]), "b": leaf(e["b"])}
                for e in man["layers"]]
    layers: List[Optional[QuantLayer]] = []
    for e in man["layers"]:
        layers.append(None if e is None else QuantLayer(
            kind=e["kind"], x_scale=e["x_scale"], y_scale=e["y_scale"],
            **{k: leaf(i) for k, i in e["arrays"].items()}))
    return QuantizedCNNParams(layers=layers, in_scale=man["in_scale"])


# -- the artifact ------------------------------------------------------------

def save_artifact(path: str, *, cfg: CNNConfig, spec: ExecutionSpec,
                  params, plan_table: PlanTable) -> Path:
    """Commit one serving artifact at ``path`` (atomic; see the module
    docstring)."""
    pman, leaves = _params_manifest(params)
    manifest = {"format": _FORMAT, "cfg": cfg_to_dict(cfg),
                "spec": spec_to_dict(spec), "params": pman}

    def write(tmp: Path) -> None:
        for i, leaf in enumerate(leaves):
            save_leaf(tmp / f"leaf_{i}.npy", leaf)
        (tmp / "plan_table.json").write_text(plan_table.to_json())
        (tmp / "manifest.json").write_text(
            json.dumps(manifest, sort_keys=True, indent=1) + "\n")

    return commit_dir(Path(path), write)


def load_artifact(path: str, *, device=None):
    """Rebuild a :class:`~repro_torch.pipeline.compile.CompiledCNN` on
    ``device`` (default: the CUDA device) from a committed artifact, the
    port's or the JAX package's (see :func:`cfg_from_dict` and
    :func:`spec_from_dict` for what a JAX one loses). The plan table
    seeds the registries: a port artifact's load runs no sweep; a JAX
    table's ``"tpu"`` rows seed nothing."""
    from repro_torch.pipeline.compile import compile_cnn

    root = Path(path)
    if not (root / "_COMMITTED").exists():
        raise CheckpointError(
            f"{root} is not a committed artifact (no _COMMITTED marker: "
            "a crashed save, or not an artifact directory)")
    manifest = json.loads((root / "manifest.json").read_text())
    if manifest.get("format") != _FORMAT:
        raise CheckpointError(
            f"artifact {root}: format {manifest.get('format')!r}, this "
            f"reader understands {_FORMAT}")
    cfg = cfg_from_dict(manifest["cfg"])
    spec = spec_from_dict(manifest["spec"])
    params = _params_from_manifest(root, manifest["params"])
    table = PlanTable.from_json((root / "plan_table.json").read_text())
    return compile_cnn(cfg, spec, params, plans=table, device=device)
