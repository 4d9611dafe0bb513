"""The port's nine examples (``src/repro_torch/examples``), each run through
its ``main`` at the JAX example's smoke size on the CPU with its outputs in
``tmp_path``.

Each must exit 0. The deterministic numbers an example prints are held
against the JAX package's functions exactly (the traffic model's bytes
and the FLOPs of ``alexnet_inference``); the files ``observe_fleet`` and
``measure_drift`` write pass the port's validators and the JAX package's
(the same schemas). The card's stopwatch is stood in for in
``measure_drift``, as in ``tests/test_torch_dse.py``. Without a card and
without ``--device``, every example raises.
"""
import importlib
import json

import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import pipeline as jpipe
from repro.core.config import flops_per_image as jax_flops
from repro.obs import validate as jvalidate
from repro_torch.kernels import autotune
from repro_torch.obs import (profiler, reconcile, validate_drift,
                             validate_metrics, validate_trace)

NAMES = ("quickstart", "alexnet_inference", "serve_batched", "serve_fleet",
         "fleet_failover", "serve_elastic", "observe_fleet", "measure_drift",
         "train_resilient")


def _main(name):
    return importlib.import_module(f"repro_torch.examples.{name}").main


def _run(name, capsys, *argv):
    assert _main(name)(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith(f"{name} OK")
    return out


def test_quickstart(tmp_path, capsys):
    out = _run("quickstart", capsys, "--out", str(tmp_path))
    assert "recompile from saved plan table: 0 DSE sweeps" in out
    assert json.loads((tmp_path / "plans.json").read_text())["format"] == 3
    assert [p.name for p in tmp_path.iterdir()] == ["plans.json"]


@pytest.mark.parametrize("batch", [16, 8])
def test_alexnet_inference_prints_jax_numbers(capsys, batch):
    out = _run("alexnet_inference", capsys, "--batch", str(batch))
    jcfg = jax_get_config("alexnet").smoke()
    unf, fus, red = jpipe.fusion_savings(jcfg, batch=batch)
    assert (f"pipeline traffic at batch {batch}: fused {fus} B vs "
            f"unfused {unf} B ({red:.1%} saved)") in out
    assert f"operations an image: {jax_flops(jcfg)}\n" in out
    assert "forwards: 51\n" in out
    assert "(host wall clock over 50 forwards" in out
    assert "the paper's FPGA figure (Altera Stratix-V" in out
    assert "on the CPU (host)" in out


@pytest.mark.parametrize("arch", ["qwen3-8b", "alexnet", "zamba2-1.2b"])
def test_serve_batched(capsys, arch):
    out = _run("serve_batched", capsys, "--arch", arch)
    if arch == "alexnet":
        assert "served 19 requests @ micro-batch 8" in out
    else:
        assert "prefill: 512 tokens" in out and "decode : 248 tokens" in out


def test_serve_fleet(capsys):
    out = _run("serve_fleet", capsys)
    assert "all modes produced identical predictions" in out
    assert out.count("67 served") == 4


def test_fleet_failover(tmp_path, capsys):
    out = _run("fleet_failover", capsys, "--out", str(tmp_path))
    assert "warm load: 0 DSE sweeps" in out
    assert "4/4 replicas rolled to int8" in out
    for art in ("alexnet_fp32", "alexnet_int8"):
        assert (tmp_path / art / "_COMMITTED").exists()


def test_serve_elastic(capsys):
    out = _run("serve_elastic", capsys)
    assert "fleet path: 2 -> 6 -> 2 replicas" in out


def test_observe_fleet_outputs_validate(tmp_path, capsys):
    out = _run("observe_fleet", capsys, "--out", str(tmp_path))
    assert "second run byte-identical" in out
    trace = json.loads((tmp_path / "trace.json").read_text())
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    report = json.loads((tmp_path / "report.json").read_text())
    assert (tmp_path / "metrics.prom").read_text().startswith("# HELP")
    for v in (validate_trace, jvalidate.validate_trace):
        assert v(trace) == []
    for v in (validate_metrics, jvalidate.validate_metrics):
        assert v(metrics) == []
    for r in (reconcile, jvalidate.reconcile):
        assert r(report, trace=trace, metrics=metrics) == []
    assert report["n_scale_up"] >= 1 and report["n_failures"] >= 1


def test_measure_drift_with_a_stand_in_stopwatch(tmp_path, capsys,
                                                 monkeypatch):
    """The stopwatch is the card's (CUDA events); here the measure
    functions return a fixed time a plan and count as the real ones."""
    def conv(shape, plan, **kw):
        autotune._MEASURE_STATS["conv_measured"] += 1
        return 1e-4 * plan.tp / 128

    def gemm(shape, plan, **kw):
        autotune._MEASURE_STATS["gemm_measured"] += 1
        return 2e-5 * plan.ranks

    monkeypatch.setattr(autotune, "measure_plan", conv)
    monkeypatch.setattr(autotune, "measure_gemm_plan", gemm)
    monkeypatch.setattr(profiler, "backend_fingerprint",
                        lambda device=None: {"platform": "cuda",
                                             "timer": "cuda events"})
    profiler.clear_measure_cache()
    out = _run("measure_drift", capsys, "--out", str(tmp_path))
    assert "coverage: 8/8 plans measured (5 conv + 3 gemm timings)" in out
    drift = json.loads((tmp_path / "drift.json").read_text())
    table = json.loads((tmp_path / "plan_table.json").read_text())
    assert validate_drift(drift, table=table) == []
    metrics = json.loads((tmp_path / "drift_metrics.json").read_text())
    assert validate_metrics(metrics) == []
    assert validate_trace(json.loads(
        (tmp_path / "compile_trace.json").read_text())) == []


def test_train_resilient_compressed_restart(tmp_path, capsys):
    out = _run("train_resilient", capsys, "--compress", "--steps", "12",
               "--fail-at", "11", "--out", str(tmp_path))
    assert "*** injecting node failure at step 11 ***" in out
    assert "[loop] restored checkpoint at step 10" in out
    log = json.loads((tmp_path / "losses.json").read_text())
    assert [m["step"] for m in log] == [*range(1, 12), 11, 12]
    assert (tmp_path / "ckpt" / "residual" / "step_00000012"
            / "_COMMITTED").exists()


@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _main(name)([])
