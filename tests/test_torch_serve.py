"""Serving parity: the port's ``compile_cnn(...).serve`` against the JAX
package's on the smoke AlexNet, the copied report helpers against the
JAX ones, and the spec errors against JAX's. The modelled clock's parity with the JAX engine is in
``tests/test_torch_dse.py``; what slice 7 lifted (the continuous
scheduler, steals, autoscaling, traces, metrics, verification) is held
against the JAX package here by knob, and in depth in
``tests/test_torch_scheduler.py``, ``test_torch_obs.py`` and
``test_torch_analysis.py``."""
import dataclasses

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
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import TraceRecorder as JTraceRecorder
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.pipeline import (AutoscalePolicy, CompiledCNN,
                                  ExecutionSpec, Placement, Precision,
                                  Serving, compile_cnn)
from repro_torch.serve import FaultSchedule, latency_report, nearest_rank
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


@pytest.fixture(scope="module")
def compiled():
    return compile_cnn(get_config("alexnet").smoke(), device="cpu")


@pytest.fixture(scope="module")
def pair():
    """The smoke AlexNet in both packages with JAX's weights, and 19
    requests in each package's types."""
    jcfg = jax_get_config("alexnet").smoke()
    jparams = jax_init_cnn_params(jax.random.key(3), jcfg)
    cfg = get_config("alexnet").smoke()
    n = default_request_count(8)
    return (jcfg, jparams, cfg, params_from_jax(jparams, "cpu"),
            synthetic_requests(n, cfg.input_hw, cfg.input_ch, 200.0),
            jax_requests(n, jcfg.input_hw, jcfg.input_ch, 200.0))


def _modelled_pair(pair, **serving):
    """Both packages' compiles on the modelled clock, the JAX engine's
    round and restore times set to the port's (the cost models differ)."""
    jcfg, jparams, cfg, params, _, _ = pair
    c = compile_cnn(cfg, ExecutionSpec(serving=Serving(
        batch=8, clock="modeled", **serving)), params, device="cpu")
    jc = jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(
        serving=jpipe.Serving(batch=8, clock="modeled", **serving),
        use_pallas=False), jparams)
    jc.engine._versions[0].update(t_round=c.engine.t_round_model,
                                  t_restore=c.engine.t_restore_model)
    return c, jc


def _events(trace):
    """The trace's events but the process name (the port names itself)."""
    return [e for e in trace.to_chrome()["traceEvents"]
            if e["name"] != "process_name"]


def _preds(rep):
    return {d.rid: d.pred for d in rep.completions}


def _lifted_continuous(pair, **serving):
    c, jc = _modelled_pair(pair, scheduler="continuous", **serving)
    rep, jrep = c.serve(pair[4]), jc.serve(pair[5])
    return (_preds(rep) == _preds(jrep) and rep.scheduler == "continuous"
            and [(d.rid, d.t_done, d.replica, d.attempts)
                 for d in rep.completions] ==
            [(d.rid, d.t_done, d.replica, d.attempts)
             for d in jrep.completions])


def _lifted_compile_trace(pair):
    jcfg, jparams, cfg, params, _, _ = pair
    t, jt = TraceRecorder(), JTraceRecorder()
    compile_cnn(cfg, ExecutionSpec(), params, device="cpu", trace=t)
    jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(use_pallas=False), jparams,
                      trace=jt)
    shape = [(e["name"], e["cat"], e["ph"], sorted(e["args"]))
             for e in _events(t) if e["ph"] != "M"]
    return shape == [(e["name"], e["cat"], e["ph"], sorted(e["args"]))
                     for e in _events(jt) if e["ph"] != "M"] == [
        ("sweep", "compile", "X", ["conv_hits", "conv_sweeps", "gemm_hits",
                                   "gemm_sweeps", "lookups"])]


def _lifted_trace(pair):
    c, jc = _modelled_pair(pair)
    t, jt = TraceRecorder(), JTraceRecorder()
    c.serve(pair[4], trace=t)
    jc.serve(pair[5], trace=jt)
    return (_events(t) == _events(jt)
            and sorted(t.to_chrome()["otherData"]) ==
            sorted(jt.to_chrome()["otherData"]))


def _lifted_metrics(pair):
    c, jc = _modelled_pair(pair, slo=1e-3)
    m, jm = MetricsRegistry(), JMetricsRegistry()
    rep, jrep = c.serve(pair[4], metrics=m), jc.serve(pair[5], metrics=jm)
    return (m.to_json() == jm.to_json() and _preds(rep) == _preds(jrep)
            and m.value("serve_done_total") == rep.n_done == 19)


def _lifted_verify(pair):
    jcfg, jparams, cfg, params, _, _ = pair
    c = compile_cnn(cfg, ExecutionSpec(), params, device="cpu")
    jc = jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(use_pallas=False),
                           jparams)
    return c.verify(strict=True) == [] == jc.verify(strict=True)


# what the parent refused by naming ROADMAP.md Queue 1 slice 7, now run
# and held against the JAX package: each knob -> a check of what it does
LIFTED_OBS = {
    "continuous": lambda p: _lifted_continuous(p),
    "autoscale": lambda p: _lifted_continuous(
        p, autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2,
                                     interval=1e-3)),
    "steal": lambda p: _lifted_continuous(p, steal_threshold=1,
                                          retries=1),
    "compile_trace": _lifted_compile_trace,
    "trace": _lifted_trace,
    "metrics": _lifted_metrics,
    "verify": _lifted_verify,
}


@pytest.mark.parametrize("knob", sorted(LIFTED_OBS))
def test_lifted_obs_knobs_run_as_in_jax(pair, knob):
    assert LIFTED_OBS[knob](pair)


def _fleet(c, **placement):
    """A compile of ``c``'s model and config at ``placement``, serving
    19 requests with two retries."""
    fc = compile_cnn(c.cfg, ExecutionSpec(
        placement=Placement(**placement),
        serving=Serving(batch=8, retries=2)), c.params, device="cpu")
    reqs = synthetic_requests(19, c.cfg.input_hw, c.cfg.input_ch, 200.0)
    return fc, fc.serve(reqs)


def _hot_swap(c):
    c.serve([])
    v = c.engine.hot_swap(c)
    rep = c.serve(synthetic_requests(5, c.cfg.input_hw, c.cfg.input_ch,
                                     200.0))
    return v, rep, c.engine._cur_version


def _save_load(c, tmp_path):
    c.save(tmp_path / "artifact")
    return CompiledCNN.load(tmp_path / "artifact", device="cpu")


# what the refusals of the parent named (the artifacts of Queue 1 slice 5,
# the fleet of slice 6), now run: each value -> a check of what it does
LIFTED = {
    "replicas": lambda c, tmp: _fleet(c, replicas=2)[1].mode == "dp",
    "pp_stages": lambda c, tmp: _fleet(c, pp_stages=2)[0].n_stages == 2,
    "microbatches": lambda c, tmp: _fleet(
        c, pp_stages=2, microbatches=2)[0].engine.n_micro == 2,
    "retries": lambda c, tmp: ExecutionSpec(
        serving=Serving(retries=1)).serving.retries == 1,
    "faults": lambda c, tmp: c.serve(
        [], faults=FaultSchedule.at(0.5)).n_failures == 0,
    "hot_swap": lambda c, tmp: _hot_swap(c)[0::2] == (1, 1),
    "save": lambda c, tmp: (c.save(tmp / "a") / "_COMMITTED").exists(),
    "load": lambda c, tmp: torch.equal(
        _save_load(c, tmp).forward(np.zeros((2, 67, 67, 3), np.float32)),
        c.forward(np.zeros((2, 67, 67, 3), np.float32))),
}


@pytest.mark.parametrize("knob", sorted(LIFTED))
def test_lifted_refusals_now_run(knob, tmp_path):
    c = compile_cnn(get_config("alexnet").smoke(), device="cpu")
    assert LIFTED[knob](c, tmp_path)


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


# -- the deprecated shims (slice 7) ---------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("quant", [False, True])
def test_cnn_forward_shim_warns_and_equals_jax(pair, quant, fused):
    """``models.cnn.cnn_forward`` (JAX's free function; ``use_pallas`` is
    ``use_kernels``, off by default): JAX's oracle logits, fp32 within
    1e-4 (``tests/test_kernels.py``'s tolerance), int8 bit for bit."""
    from repro.models.cnn import cnn_forward as jax_cnn_forward
    from repro.quant import calibrate_cnn as jax_calibrate_cnn
    from repro_torch.models.cnn import cnn_forward
    from repro_torch.quant import qparams_from_jax
    jcfg, jparams, cfg, params, _, _ = pair
    x = np.random.default_rng(9).standard_normal(
        (4, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    if quant:
        jparams = jax_calibrate_cnn(jparams, jax.numpy.asarray(x), jcfg)
        params = qparams_from_jax(jparams, "cpu")
    want = np.asarray(jax_cnn_forward(jparams, jax.numpy.asarray(x), jcfg,
                                      fused=fused))
    with pytest.warns(DeprecationWarning, match="compile_cnn"):
        got = cnn_forward(params, torch.from_numpy(x), cfg,
                          fused=fused).numpy()
    if quant:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serve_shim_warns_and_serves_jaxs_predictions(pair, served):
    from repro.launch.serve_cnn import serve as jax_serve
    from repro_torch.launch.serve_cnn import serve
    jcfg, jparams, cfg, params, reqs, jreqs = pair
    with pytest.warns(DeprecationWarning, match="compile_cnn"):
        done = serve(cfg, params, reqs, batch=8, use_kernels=False,
                     device="cpu")
    jdone = jax_serve(jcfg, jparams, jreqs, batch=8, use_pallas=False)
    assert {c.rid: c.pred for c in done} == {c.rid: c.pred for c in jdone}
    assert {c.rid: c.pred for c in done} == {
        c.rid: c.pred for c in served[2].completions}


def test_spec_from_config_and_resolve_config_warn_and_bridge():
    from repro_torch.pipeline import resolve_config, spec_from_config
    jcfg = jax_get_config("alexnet")
    cfg = get_config("alexnet")
    with pytest.warns(DeprecationWarning):
        spec = spec_from_config(cfg, use_kernels=False)
    jspec = jpipe.spec_from_config(jcfg, use_pallas=False)
    for sub in ("precision", "placement", "serving"):
        assert dataclasses.asdict(getattr(spec, sub)) == \
            dataclasses.asdict(getattr(jspec, sub))
    assert spec.tiling.autotune == jspec.tiling.autotune
    assert spec.use_kernels is False
    with pytest.warns(DeprecationWarning):
        assert resolve_config(cfg, spec) is cfg
