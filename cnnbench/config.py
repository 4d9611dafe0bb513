"""What ``BENCHMARK.json`` names, resolved to the files under ``cnnbench/``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in a file of its own, found by its name:

* ``configs/<config>.json``: the model's layers, input, precision and
  weight scales (the configuration as it is run);
* ``traffic/<traffic>.json``: the parameters of the general generator
  (:mod:`cnnbench.traffic`);
* ``limits/<workload>.json``: the limit of each number the cell's
  correctness check compares, with the readings it was set from;
* ``metrics/<metric>.py``: one reader a metric (:func:`metric_reader`).

So a later change adds a cell, a configuration or a metric by adding
files and entries, and edits none. Nothing here imports torch.
"""
from __future__ import annotations

import importlib.util
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

LAYER_DEFAULTS = {"out_ch": 0, "kernel": 0, "stride": 1, "pad": 0,
                  "groups": 1, "pool": "max", "relu": True}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return read_json(path)


def layers(cfg: dict) -> List[dict]:
    """The configuration's layers with every key filled in."""
    return [{**LAYER_DEFAULTS, **l} for l in cfg["layers"]]


def fusion_groups(cfg: dict) -> List[Tuple[int, ...]]:
    """PipeCNN's stages: a conv and the pool right after it are one group;
    an LRN, a standalone pool and an FC are a group each."""
    ls = cfg["layers"]
    out, i = [], 0
    while i < len(ls):
        if ls[i]["kind"] == "conv" and i + 1 < len(ls) \
                and ls[i + 1]["kind"] == "pool":
            out.append((i, i + 1))
            i += 2
        else:
            out.append((i,))
            i += 1
    return out


def group_shapes(cfg: dict):
    """Yield ``(group, in_shape, out_shape)`` of every fusion group for one
    image: NHWC shapes without the batch, ``(features,)`` after an FC."""
    ls = layers(cfg)
    shape = (cfg["input_hw"], cfg["input_hw"], cfg["input_ch"])
    for group in fusion_groups(cfg):
        cur = shape
        for i in group:
            l = ls[i]
            if l["kind"] == "conv":
                h = (cur[0] + 2 * l["pad"] - l["kernel"]) // l["stride"] + 1
                cur = (h, h, l["out_ch"])
            elif l["kind"] == "pool":
                h = (cur[0] - l["kernel"]) // l["stride"] + 1
                cur = (h, h, cur[2])
            elif l["kind"] == "fc":
                cur = (l["out_ch"],)
        yield group, shape, cur
        shape = cur


def shrink(cfg: dict) -> dict:
    """The same topology with every width cut sixteen-fold (at least 8),
    16 classes and at most a 67-pixel input: the size the CPU tests run.
    Never used by a benchmark run."""
    ls = []
    for l in cfg["layers"]:
        l = dict(l)
        if l.get("out_ch"):
            l["out_ch"] = max(8, l["out_ch"] // 16)
        ls.append(l)
    ls[-1]["out_ch"] = 16
    return {**cfg, "layers": ls, "n_classes": 16,
            "input_hw": min(cfg["input_hw"], 67)}


def config_file(bench: dict, name: str) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return ROOT / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str, e2e_names) -> bool:
    """Whether a metric is reported in a cell: its ``workloads`` list, or,
    without one, every cell that reports the metric it moves (an
    end-to-end metric without the list: every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def resolve(workload: str, bench: dict = None) -> dict:
    """Everything one cell needs: its entry, its configuration, its traffic
    mix, its limits and the metrics it reports (end-to-end and per-layer
    entries of ``BENCHMARK.json``)."""
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = cells[workload]
    e2e = [m for m in bench["end_to_end"]
           if applies(m, workload, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m, workload, e2e_names)]
    return {"cell": cell,
            "config": read_json(config_file(bench, cell["config"])),
            "traffic": read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            "limits": read_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": per_layer,
            "run_seconds": bench["run_seconds"]}


@lru_cache(maxsize=None)
def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py`` (loaded by path:
    a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cnnbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: List[dict], ctx: dict) -> Dict[str, dict]:
    """Each entry's reading as ``{name: {"value", "unit"}}``; a reader that
    finds nothing to read returns None, and the metric is left out."""
    out = {}
    for m in entries:
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
