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

A configuration's ``layers`` run in their order, each a dict with ``kind``
(``conv``, ``pool``, ``lrn`` or ``fc``) and the keys of
:data:`LAYER_DEFAULTS`. Three optional keys make a graph of the chain; a
layer without them means what it means in a chain:

* ``input``: the index of the layer whose output this layer reads, ``-1``
  for the image; by default the layer before;
* ``residual`` (a conv): the index of the layer whose output is added to
  the conv's after the bias and before the ReLU (the arithmetic of each
  precision is :mod:`cnnbench.reference`'s);
* ``pad`` (a pool): a max pool pads each side with minus infinity; an avg
  pool with ``pad`` above 0 is refused.

An index names an earlier layer or the image, and the shapes agree (a
residual's source has the conv's output shape), else :func:`layer_shapes`
raises, naming the layer. A conv and the pool after it fuse only where
nothing else reads the conv (:func:`fusion_groups`), so every index names
a fusion group's output.
"""
from __future__ import annotations

import importlib.util
import json
from collections import Counter
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

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


Shape = Tuple[int, ...]


def layers(cfg: dict) -> List[dict]:
    """The configuration's layers with every key filled in."""
    return [{**LAYER_DEFAULTS, **l} for l in cfg["layers"]]


def source(ls: List[dict], i: int) -> int:
    """The index of the layer whose output layer ``i`` reads (-1: the
    image)."""
    return ls[i].get("input", i - 1)


def fusion_groups(cfg: dict) -> List[Tuple[int, ...]]:
    """PipeCNN's stages: a conv and the pool right after it are one group
    when the pool reads the conv and nothing else does; an LRN, any other
    pool and an FC are a group each."""
    ls = cfg["layers"]
    reads = Counter(source(ls, j) for j in range(len(ls)))
    reads.update(l["residual"] for l in ls if "residual" in l)
    out, i = [], 0
    while i < len(ls):
        if ls[i]["kind"] == "conv" and i + 1 < len(ls) \
                and ls[i + 1]["kind"] == "pool" \
                and source(ls, i + 1) == i and reads[i] == 1:
            out.append((i, i + 1))
            i += 2
        else:
            out.append((i,))
            i += 1
    return out


def group_sources(cfg: dict) -> List[Tuple[Tuple[int, ...], int,
                                          Optional[int]]]:
    """``(group, source, residual)`` of every fusion group in order: the
    index of the output its first layer reads, and its residual's source
    (None without one)."""
    ls = cfg["layers"]
    return [(g, source(ls, g[0]), ls[g[0]].get("residual"))
            for g in fusion_groups(cfg)]


class EmptyOutput(ValueError):
    """A layer's output has no pixel at the configuration's input size."""


def _check_index(ls: List[dict], i: int, key: str) -> None:
    j = ls[i][key]
    if type(j) is not int or not -1 <= j < i:
        raise ValueError(f"cnnbench: layer {i} ({ls[i]['kind']}): {key} "
                         f"{j!r} names no earlier layer nor the image (-1)")


def layer_shapes(cfg: dict) -> List[Shape]:
    """Each layer's output shape for one image: NHWC without the batch,
    ``(features,)`` after an FC. Raises ``ValueError``, naming the layer,
    where the configuration breaks a rule of the module's docstring, and
    :class:`EmptyOutput` where a layer's output is empty."""
    ls = layers(cfg)
    image = (cfg["input_hw"], cfg["input_hw"], cfg["input_ch"])
    shapes: List[Shape] = []
    for i, l in enumerate(ls):
        where = f"cnnbench: layer {i} ({l['kind']})"
        for key in ("input", "residual"):
            if key in l:
                _check_index(ls, i, key)
        j = source(ls, i)
        cur = image if j == -1 else shapes[j]
        if l["kind"] in ("conv", "pool"):
            if len(cur) != 3:
                raise ValueError(f"{where} reads the flat output of layer "
                                 f"{j}")
            if l["kind"] == "pool" and l["pool"] == "avg" and l["pad"]:
                raise ValueError(f"{where}: an avg pool takes no pad")
            if l["kind"] == "conv" and (cur[2] % l["groups"]
                                        or l["out_ch"] % l["groups"]):
                raise ValueError(f"{where}: groups {l['groups']} divides "
                                 f"not both {cur[2]} and {l['out_ch']} "
                                 f"channels")
            h = (cur[0] + 2 * l["pad"] - l["kernel"]) // l["stride"] + 1
            if h < 1:
                raise EmptyOutput(f"{where}: no output pixel from "
                                  f"{cur[0]} x {cur[0]}")
            cur = (h, h, l["out_ch"] if l["kind"] == "conv" else cur[2])
        elif l["kind"] == "fc":
            cur = (l["out_ch"],)
        if "residual" in l:
            r = l["residual"]
            if l["kind"] != "conv":
                raise ValueError(f"{where}: only a conv takes a residual")
            if (image if r == -1 else shapes[r]) != cur:
                raise ValueError(f"{where}: residual {r}'s shape is not "
                                 f"the conv's {cur}")
        shapes.append(cur)
    return shapes


def group_shapes(cfg: dict) -> Iterator[Tuple[Tuple[int, ...], Shape,
                                              Shape, Optional[Shape]]]:
    """Yield ``(group, in_shape, out_shape, residual_shape)`` of every
    fusion group for one image (:func:`layer_shapes`' shapes; the residual
    source's shape None without one)."""
    shapes = layer_shapes(cfg)
    image = (cfg["input_hw"], cfg["input_hw"], cfg["input_ch"])
    at = lambda j: image if j == -1 else shapes[j]
    for group, src, res in group_sources(cfg):
        yield group, at(src), shapes[group[-1]], \
            None if res is None else at(res)


def shrink(cfg: dict) -> dict:
    """The same graph with every width cut sixteen-fold (at least 8), 16
    classes, and the input at most 67 pixels, or the least size above that
    at which no layer's output is empty: the size the CPU tests run. A
    depthwise conv (``groups`` equal to its input channels) stays one.
    Never used by a benchmark run."""
    full = layer_shapes(cfg)
    ls, ch = [], {-1: cfg["input_ch"]}
    for i, l in enumerate(cfg["layers"]):
        l = dict(l)
        if l.get("out_ch"):
            l["out_ch"] = max(8, l["out_ch"] // 16)
        if i == len(cfg["layers"]) - 1:
            l["out_ch"] = 16
        j = source(cfg["layers"], i)
        in_ch = cfg["input_ch"] if j == -1 else full[j][-1]
        if l["kind"] == "conv" and l.get("groups", 1) > 1 \
                and l["groups"] == in_ch:
            l["groups"] = ch[j]
        ch[i] = l["out_ch"] if l.get("out_ch") else ch[j]
        ls.append(l)
    small = {**cfg, "layers": ls, "n_classes": 16}

    def fits(hw: int) -> bool:
        try:
            layer_shapes({**small, "input_hw": hw})
        except EmptyOutput:
            return False
        return True
    small["input_hw"] = next(hw for hw in range(min(cfg["input_hw"], 67),
                                                cfg["input_hw"] + 1)
                             if fits(hw))
    return small


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
