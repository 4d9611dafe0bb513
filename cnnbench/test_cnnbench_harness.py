"""The harness against its contract, on the CPU at the small size of
``config.shrink`` (the card's runs are the ``card`` test at the end)."""
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cnnbench import config, counts, harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = config.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"]


def test_benchmark_json_keeps_the_contracts_shape():
    assert list(BENCH) == TOP_KEYS
    assert BENCH["paths"] == ["cnnbench"]
    assert BENCH["command"] == ["python3", "cnnbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cnnbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= set(CELLS)
    for cell in CELLS:
        r = config.resolve(cell, BENCH)
        got = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2 and r["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_a_cell_names_resolves(cell):
    r = config.resolve(cell, BENCH)
    for m in r["end_to_end"] + r["per_layer"]:
        assert callable(config.metric_reader(m["name"]))
    kind = {"open": "top1_gap", "closed": "logit_err"}[
        r["traffic"]["arrivals"]]
    assert r["limits"][kind]["limit"] > 0
    assert r["traffic"]["batch"] >= 1


@pytest.mark.parametrize("name,model", [("vgg16_bf16", "vgg16"),
                                        ("alexnet_int8", "alexnet")])
def test_configurations_are_the_ports_published_models(name, model):
    from repro_torch.configs import get_config
    from cnnbench.program import port_config
    cfg = config.read_json(config.config_file(BENCH, name))
    ours, port = port_config(cfg), get_config(model)
    assert ours.layers == port.layers
    assert (ours.input_hw, ours.input_ch, ours.n_classes) == \
        (port.input_hw, port.input_ch, port.n_classes)


def test_conv_group_counts_equal_the_hand_sum():
    """VGG-16 conv1_2 with its pool, bf16, batch 8: 224 x 224 x 64 in,
    3 x 3 x 64 x 64 weights, 112 x 112 x 64 out."""
    cfg = config.read_json(config.config_file(BENCH, "vgg16_bf16"))
    row = [r for r in counts.group_counts(cfg, 8) if r["group"] == (1, 2)][0]
    ops = 2 * 8 * 224 * 224 * 64 * 3 * 3 * 64
    nbytes = (8 * 224 * 224 * 64 * 2 + 3 * 3 * 64 * 64 * 2 + 64 * 2
              + 8 * 112 * 112 * 64 * 2)
    assert (row["kind"], row["ops"], row["bytes"]) == ("conv", ops, nbytes)
    assert row["bound_s"] == max(ops / 989e12, nbytes / 3.35e12)


def test_fc_group_counts_equal_the_hand_sum():
    """AlexNet fc6, int8, batch 128: 6 x 6 x 256 = 9216 codes in, 9216 x 4096
    weight codes, fp32 bias and step products, 4096 codes out."""
    cfg = config.read_json(config.config_file(BENCH, "alexnet_int8"))
    fcs = [r for r in counts.group_counts(cfg, 128) if r["kind"] == "fc"]
    row = fcs[0]
    ops = 2 * 128 * 9216 * 4096
    nbytes = 128 * 9216 + 9216 * 4096 + 4096 * 8 + 128 * 4096
    assert (row["ops"], row["bytes"]) == (ops, nbytes)
    assert row["bound_s"] == max(ops / 1979e12, nbytes / 3.35e12)
    # the logits leave the last group in fp32
    assert fcs[-1]["bytes"] == 128 * 4096 + 4096 * 1000 + 1000 * 8 \
        + 128 * 1000 * 4
    assert counts.forward_ops(cfg, 1) == 2 * 724406816


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_exactly_the_contracts_keys(cell, trace):
    out = harness.run_cell(cell, 2 ** 31 + 11, 0.3, trace, device="cpu",
                           shrink=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    r = config.resolve(cell, BENCH)
    want = {m["name"] for m in (r["per_layer"] if trace
                                else r["end_to_end"])}
    # a CPU run has no device trace: those readers find nothing to read
    traced = {m["name"] for m in r["per_layer"]
              if m["source"] == "device_trace"}
    assert set(out["metrics"]) == want - traced
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and math.isfinite(v["value"])
    assert json.loads(json.dumps(out)) == out


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    p = subprocess.run([sys.executable, "cnnbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "memory_peak_bytes" not in p.stderr


def test_a_checkout_without_the_port_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cnnbench", tmp_path / "cnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "cnnbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell, cuda):
    p = subprocess.run([sys.executable, "cnnbench/run.py", "--workload",
                        cell, "--seed", "4294967301", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["compared"]
    assert out["device"]["platform"] == "gpu"
