"""Operations and bytes of each fusion group, from the configuration's
shapes alone, and the card's published peaks (``peaks.json``).

The counts are the benchmark's own, so that no change to the program can
move the yardstick: a conv or FC group does 2 operations a
multiply-accumulate; its bytes are each input read once (activation,
weights, bias, and in fixed point the per-channel step products) and its
output written once, whatever a kernel reads again. A conv with a
``residual`` also reads its source once. The residual's adds stay out of
the operations: one an output element, 5.5 M an image in ResNet-50, under
0.1 % of its 8.2 G. A group's bound is the larger of its operations over
the precision's peak and its bytes over the memory's rate.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Dict, List

from cnnbench.config import (HERE, group_shapes, layer_shapes, layers,
                             read_json)


@lru_cache(maxsize=None)
def peaks() -> dict:
    return read_json(HERE / "peaks.json")


def run_dtype(cfg: dict) -> str:
    """The dtype the kernels compute in: ``int8`` for a fixed-point
    configuration, else the float dtype."""
    p = cfg["precision"]
    return "int8" if p.get("quant", "none") == "int8" else p["dtype"]


def _sizes(cfg: dict) -> Dict[str, int]:
    """Bytes an element of the activations, weights, bias and step
    products of the run dtype; the fixed-point logits are fp32."""
    return {"bfloat16": {"act": 2, "w": 2, "b": 2, "mult": 0},
            "float32": {"act": 4, "w": 4, "b": 4, "mult": 0},
            "int8": {"act": 1, "w": 1, "b": 4, "mult": 4}}[run_dtype(cfg)]


def group_counts(cfg: dict, batch: int) -> List[dict]:
    """One row a conv and FC group at ``batch``: ``kind`` (``conv`` or
    ``fc``), ``ops``, ``bytes`` and ``bound_s``."""
    ls, sz = layers(cfg), _sizes(cfg)
    pk = peaks()
    rate = pk["ops_per_s"][run_dtype(cfg)]
    rows = []
    shapes = layer_shapes(cfg)
    groups = list(group_shapes(cfg))
    for gi, (group, ins, outs, res) in enumerate(groups):
        l = ls[group[0]]
        if l["kind"] not in ("conv", "fc"):
            continue
        fan_in = (l["kernel"] ** 2 * ins[2] // l["groups"]
                  if l["kind"] == "conv" else math.prod(ins))
        macs = math.prod(shapes[group[0]]) * fan_in
        out_elem = 4 if (gi == len(groups) - 1 and sz["mult"]) \
            else sz["act"]
        nbytes = (batch * math.prod(ins) * sz["act"]
                  + fan_in * l["out_ch"] * sz["w"]
                  + l["out_ch"] * (sz["b"] + sz["mult"])
                  + batch * math.prod(outs) * out_elem)
        if res is not None:
            nbytes += batch * math.prod(res) * sz["act"]
        ops = 2 * batch * macs
        rows.append({"group": group, "kind": l["kind"], "ops": ops,
                     "bytes": nbytes,
                     "bound_s": max(ops / rate,
                                    nbytes / pk["bytes_per_s"])})
    return rows


def forward_ops(cfg: dict, batch: int) -> int:
    """Operations of one forward at ``batch``: its conv and FC groups'."""
    return sum(r["ops"] for r in group_counts(cfg, batch))


def peak_ops(cfg: dict) -> float:
    return peaks()["ops_per_s"][run_dtype(cfg)]
