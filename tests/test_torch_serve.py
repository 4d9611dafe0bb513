"""Serving parity: the port's ``compile_cnn(...).serve`` against the JAX
package's on the smoke AlexNet, the copied report helpers against the
JAX ones, and the spec/compile refusals of what the port does not run.
The modelled clock's parity with the JAX engine is in
``tests/test_torch_dse.py``."""
import jax
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.launch.serve_cnn import synthetic_requests as jax_requests
from repro.models.cnn import init_cnn_params as jax_init_cnn_params
from repro.serve import report as jreport
from repro.serve.router import Completion as JCompletion
from repro_torch.configs import get_config
from repro_torch.core.config import SpecError
from repro_torch.launch.serve_cnn import (default_request_count, main,
                                          synthetic_requests)
from repro_torch.models.cnn import params_from_jax
from repro_torch.pipeline import (CompiledCNN, ExecutionSpec, Placement,
                                  Precision, Serving, compile_cnn)
from repro_torch.serve import latency_report, nearest_rank
from repro_torch.serve.router import Completion


@pytest.fixture(scope="module")
def served():
    jcfg = jax_get_config("alexnet").smoke()
    cfg = get_config("alexnet").smoke()
    jparams = jax_init_cnn_params(jax.random.key(3), jcfg)
    n = default_request_count(8)
    jrep = jpipe.compile_cnn(
        jcfg, jpipe.ExecutionSpec(serving=jpipe.Serving(batch=8),
                                  use_pallas=False), jparams).serve(
        jax_requests(n, jcfg.input_hw, jcfg.input_ch, 200.0))
    rep = compile_cnn(cfg, ExecutionSpec(serving=Serving(batch=8)),
                      params_from_jax(jparams, "cpu"), device="cpu").serve(
        synthetic_requests(n, cfg.input_hw, cfg.input_ch, 200.0))
    return n, jrep, rep


def test_request_stream_is_the_jax_launchers():
    a = synthetic_requests(7, 9, 3, 50.0, seed=4)
    b = jax_requests(7, 9, 3, 50.0, seed=4)
    assert [(r.rid, r.t_arrival) for r in a] == [(r.rid, r.t_arrival)
                                                for r in b]
    for r, s in zip(a, b):
        np.testing.assert_array_equal(r.image, s.image)


def test_serve_preds_match_jax(served):
    n, jrep, rep = served
    assert default_request_count(8) == n == 19
    assert {c.rid: c.pred for c in rep.completions} == \
        {c.rid: c.pred for c in jrep.completions}


def test_every_request_completes_ok(served):
    n, _, rep = served
    assert sorted(c.rid for c in rep.completions) == list(range(n))
    assert all(c.status == "ok" and c.t_done >= c.t_arrival
               for c in rep.completions)
    assert rep.n_done == n and rep.n_rejected == 0 and rep.rounds >= 3
    assert rep.mode == "single" and rep.clock == "measured"
    assert rep.to_dict()["n_done"] == n and "completions" not in rep.to_dict()


def test_latency_report_and_nearest_rank_match_jax():
    lats = [0.25, 1.5, 0.75, 3.0, 0.5, 2.25, 1.0]
    mk = [(i, 1.0 + i, 1.0 + i + d) for i, d in enumerate(lats)]
    got = latency_report([Completion(rid=i, pred=0, t_arrival=a, t_done=d)
                          for i, a, d in mk])
    want = jreport.latency_report(
        [JCompletion(rid=i, pred=0, t_arrival=a, t_done=d) for i, a, d in mk])
    assert got == pytest.approx(want)
    s = sorted(lats)
    for q in (0.0, 0.01, 0.5, 0.95, 1.0):
        assert nearest_rank(s, q) == jreport.nearest_rank(s, q)
    for fn in (latency_report, jreport.latency_report):
        empty = fn([])
        assert empty["n"] == 0 and np.isnan(empty["p50_ms"])


@pytest.mark.parametrize("make", [
    lambda: Serving(batch=0), lambda: Serving(max_queue=-1),
    lambda: Serving(clock="wall"), lambda: Serving(scheduler="fifo"),
    lambda: Precision(dtype="float16"), lambda: Precision(quant="int4"),
    lambda: Placement(replicas=0), lambda: Serving(execute=False)],
    ids=["batch", "max_queue", "clock", "scheduler", "dtype", "quant",
         "replicas", "execute"])
def test_invalid_values_fail_on_the_same_field_as_jax(make):
    sub = make()
    name = type(sub).__name__
    jsub = getattr(jpipe, name)(**sub.__dict__)
    field_name = name.lower()
    with pytest.raises(SpecError) as got:
        ExecutionSpec(**{field_name: sub})
    with pytest.raises(jpipe.SpecError) as want:
        jpipe.ExecutionSpec(**{field_name: jsub})
    assert got.value.field == want.value.field


def _hot_swap(c):
    c.serve([])
    c.engine.hot_swap(c)


@pytest.fixture(scope="module")
def compiled():
    return compile_cnn(get_config("alexnet").smoke(), device="cpu")


REFUSED = {
    "replicas": lambda c: ExecutionSpec(placement=Placement(replicas=2)),
    "pp_stages": lambda c: ExecutionSpec(placement=Placement(pp_stages=2)),
    "microbatches": lambda c: ExecutionSpec(
        placement=Placement(microbatches=2)),
    "continuous": lambda c: ExecutionSpec(
        serving=Serving(scheduler="continuous")),
    "autoscale": lambda c: ExecutionSpec(serving=Serving(autoscale={})),
    "steal": lambda c: ExecutionSpec(serving=Serving(steal_threshold=2)),
    "retries": lambda c: ExecutionSpec(serving=Serving(retries=1)),
    "compile_trace": lambda c: compile_cnn(c.cfg, device="cpu",
                                           trace=object()),
    "faults": lambda c: c.serve([], faults=object()),
    "trace": lambda c: c.serve([], trace=object()),
    "metrics": lambda c: c.serve([], metrics=object()),
    "hot_swap": lambda c: _hot_swap(c),
    "save": lambda c: c.save("artifact"),
    "load": lambda c: CompiledCNN.load("artifact"),
    "verify": lambda c: c.verify(),
}


@pytest.mark.parametrize("knob", sorted(REFUSED))
def test_refused_knobs_name_their_roadmap_item(compiled, knob):
    with pytest.raises(SpecError, match=r"ROADMAP\.md Queue"):
        REFUSED[knob](compiled)


def test_compile_rejects_unknown_keywords(compiled):
    with pytest.raises(TypeError):
        compile_cnn(compiled.cfg, device="cpu", no_such_knob=1)


def test_serve_cnn_cli_on_cpu(capsys):
    main(["--smoke", "--device", "cpu", "--requests", "5", "--batch", "4"])
    out = capsys.readouterr().out
    assert "5 served" in out and "on cpu" in out


def test_serve_cnn_cli_int8_on_cpu(capsys):
    main(["--smoke", "--device", "cpu", "--quant", "int8", "--calib", "4",
          "--requests", "5", "--batch", "4"])
    out = capsys.readouterr().out
    assert "5 served" in out and "on cpu, int8" in out
    assert "int8 calibration: 4 images, 5 conv layers" in out


@pytest.fixture(scope="module")
def served_int8():
    jcfg = jax_get_config("alexnet").smoke()
    cfg = get_config("alexnet").smoke()
    jparams = jax_init_cnn_params(jax.random.key(3), jcfg)
    n = default_request_count(8)
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(quant="int8"), serving=Serving(batch=8)),
        params_from_jax(jparams, "cpu"), device="cpu")
    reqs = synthetic_requests(n, cfg.input_hw, cfg.input_ch, 200.0)
    return n, reqs, compiled, compiled.serve(reqs)


def test_int8_serve_completes_every_request_ok(served_int8):
    n, _, compiled, rep = served_int8
    assert compiled.quant and compiled.engine.device == torch.device("cpu")
    assert sorted(c.rid for c in rep.completions) == list(range(n))
    assert all(c.status == "ok" for c in rep.completions)
    assert rep.n_done == n and rep.n_rejected == 0


def test_int8_serve_preds_equal_the_forward(served_int8):
    n, reqs, compiled, rep = served_int8
    imgs = np.stack([r.image for r in reqs])
    preds = np.concatenate([compiled.forward(imgs[i:i + 8]).argmax(-1)
                            for i in range(0, n, 8)])
    assert {c.rid: c.pred for c in rep.completions} == dict(
        enumerate(preds.tolist()))


def test_forward_stage_fold_equals_forward(compiled):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 67, 67, 3)).astype(np.float32))
    h = x
    for i in range(compiled.n_stages):
        h = compiled.forward_stage(i, h)
    torch.testing.assert_close(h, compiled.forward(x), rtol=0, atol=0)
