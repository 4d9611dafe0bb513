"""The port's observability (slice 7) against the JAX package's, on the
CPU: ``obs/trace.py``, ``obs/metrics.py``, ``obs/validate.py`` and
``obs/drift.py``, the compile trace and the CLI outputs.

Mirrors ``tests/test_obs.py`` on the port: the recorder's Chrome shape,
order and byte determinism; the validators; the registry's kinds,
snapshot and Prometheus text; the nearest-rank rule exhaustively against
numpy's inverted CDF (n 1..200) and the histogram's bracketing bucket
against JAX's for the same samples; a fault-injected, autoscaled
continuous fleet whose trace, metrics and report reconcile exactly and
repeat byte for byte; the gang loop reconciling too. The same document
built by both packages is compared as JSON (exact). ``drift_report`` of
the committed ``tests/fixtures/plan_table_format3.json`` equals JAX's;
the port's own format-3 table (the card's stopwatch stood in for by a
fixed time a plan, as in ``tests/test_torch_dse.py``) passes
``validate_drift``; ``compile_cnn(trace=, measure=True)`` records one
``sweep`` span and one ``measure`` span a plan; and ``serve_cnn``'s
``--trace-out``, ``--metrics-out``, ``--report-json`` and ``--drift-out``
files validate and reconcile, also through the CLIs.
"""
import json
import math
from pathlib import Path

import numpy as np
import pytest

from repro import obs as jobs
from repro.obs import drift as jdrift
from repro.serve import report as jreport
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.kernels import autotune
from repro_torch.launch import serve_cnn
from repro_torch.obs import (DEFAULT_LATENCY_BUCKETS, MetricsRegistry,
                             TraceRecorder, drift, profiler, reconcile,
                             validate_drift, validate_metrics,
                             validate_trace)
from repro_torch.obs.metrics import _nearest_rank_index
from repro_torch.pipeline import (AutoscalePolicy, ExecutionSpec, PlanTable,
                                  Serving, compile_cnn)
from repro_torch.serve import FaultSchedule, Request, ServeEngine
from repro_torch.serve.report import fleet_report, nearest_rank

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "plan_table_format3.json"


# -- the trace recorder ---------------------------------------------------

def _build(mod):
    tr = mod.TraceRecorder()
    tr.track("fleet")
    tr.track("replica 0")
    tr.span("late", 0.005, 0.006, track="replica 0")
    tr.span("round", 0.001, 0.002, track="replica 0",
            args={"n_real": 3})
    tr.instant("fail", 0.0015, args={"replica": 0})
    tr.instant("mid", 0.002)
    tr.set_meta("k", "v")
    return tr


def test_trace_recorder_equals_jax_but_the_process_name(tmp_path):
    got, want = _build(obs), _build(jobs)
    doc, jdoc = json.loads(got.to_json()), json.loads(want.to_json())
    assert doc["traceEvents"][0]["args"] == {"name": "repro_torch.serve"}
    doc["traceEvents"][0]["args"] = jdoc["traceEvents"][0]["args"]
    assert doc == jdoc
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"] == [
        "round", "fail", "mid", "late"]
    assert "seq" not in doc["traceEvents"][-1]
    assert got.count("fail") == 1 and len(got) == 4
    assert got.to_json() == _build(obs).to_json()
    p = tmp_path / "t.json"
    got.save(p)
    assert p.read_text() == got.to_json()
    assert validate_trace(doc) == []


def test_validate_trace_catches_what_jax_catches():
    bad_span = {"traceEvents": [
        {"name": "s", "ph": "X", "pid": 1, "tid": 0, "ts": 3.0,
         "dur": -1.0, "cat": "c"}]}
    tr = TraceRecorder()
    tr.instant("b", 0.002)
    tr.instant("a", 0.001)
    unsorted = json.loads(tr.to_json())
    unsorted["traceEvents"].reverse()
    for doc in ({"traceEvents": "nope"}, bad_span, unsorted,
                {"traceEvents": [{"ph": "Q"}, 7]}):
        assert validate_trace(doc) == jobs.validate_trace(doc) != []


# -- the metrics registry -------------------------------------------------

def _fill(mod):
    m = mod.MetricsRegistry()
    c = m.counter("serve_done_total", "requests served ok")
    c.inc()
    c.inc(4)
    assert m.counter("serve_done_total") is c
    m.gauge("fleet_load", "fleet load").set(0.5)
    h = m.histogram("request_latency_seconds", "latency")
    for v in (3e-3, 1e-5, 2e-5, 90.0, 0.0):
        h.observe(v)
    w = m.window("lat_window", size=8, help="w")
    for v in (5.0, 1.0, 3.0, 2.0, 9.0, 4.0, 8.0, 7.0, 6.0):
        w.observe(v)
    return m


def test_metrics_registry_equals_jax(tmp_path):
    m, jm = _fill(obs), _fill(jobs)
    assert m.to_json() == jm.to_json()
    assert m.to_prometheus() == jm.to_prometheus()
    assert m.value("serve_done_total") == 5 and m.value("nope") == 0
    assert m.windows["lat_window"].percentile(0.95) == \
        jm.windows["lat_window"].percentile(0.95)
    with pytest.raises(ValueError, match="already registered"):
        m.gauge("serve_done_total")
    snap = json.loads(m.to_json())
    assert validate_metrics(snap) == [] and \
        snap["histograms"]["request_latency_seconds"]["buckets"] == list(
            DEFAULT_LATENCY_BUCKETS) == list(jobs.DEFAULT_LATENCY_BUCKETS)
    m.save(tmp_path / "m.prom")
    assert (tmp_path / "m.prom").read_text().startswith("# HELP")
    m.save(tmp_path / "m.json")
    assert json.loads((tmp_path / "m.json").read_text()) == snap
    snap["histograms"]["request_latency_seconds"]["count"] = 9
    assert validate_metrics(snap) == jobs.validate_metrics(snap) != []


def test_nearest_rank_exhaustive_vs_numpy_inverted_cdf():
    """The report's and the registry's nearest rank, and the histogram's
    bracketing bucket, for every n in 1..200 and the report's quantiles:
    numpy's inverted CDF, and JAX's functions on the same samples."""
    for n in range(1, 201):
        xs = sorted(np.random.default_rng(n).exponential(1e-2, n).tolist())
        h, jh = (mod.MetricsRegistry().histogram("h") for mod in (obs, jobs))
        for v in xs:
            h.observe(v)
            jh.observe(v)
        for q in (0.5, 0.9, 0.95, 0.99):
            want = float(np.percentile(xs, q * 100, method="inverted_cdf"))
            assert nearest_rank(xs, q) == want == jreport.nearest_rank(xs, q)
            assert xs[_nearest_rank_index(n, q)] == want
            lo, hi = h.percentile_bounds(q)
            assert (lo, hi) == jh.percentile_bounds(q)
            assert lo < want <= hi and hi == h.percentile(q)


def test_fleet_report_summary_renders_na_for_zero_completions():
    rep = fleet_report([], [], mode="dp", replicas=2, pp_stages=1, batch=8,
                       clock="modeled", rounds=0, busy_s=[0.0, 0.0],
                       makespan_s=0.0, scheduler="continuous")
    assert "p50 n/a, p95 n/a" in rep.summary() and "nan" not in \
        rep.summary() and "boundaries" in rep.summary()
    d = rep.to_dict()
    assert math.isnan(d["p50_ms"]) and d["replicas_final"] == 2
    jd = jreport.fleet_report([], [], mode="dp", replicas=2, pp_stages=1,
                              batch=8, clock="modeled", rounds=0,
                              busy_s=[0.0, 0.0], makespan_s=0.0,
                              scheduler="continuous").to_dict()
    assert set(d) - set(jd) == {"device"} and set(jd) <= set(d)


# -- one set of books: a faulted, autoscaled fleet ------------------------

@pytest.fixture(scope="module")
def model():
    return compile_cnn(get_config("alexnet").smoke(),
                       ExecutionSpec(serving=Serving(batch=8)),
                       device="cpu").model


def _chaos_autoscale_run(model):
    """The JAX test's fault-injected autoscaled continuous run, 3 -> up to
    8 replicas at three times the 3-replica capacity, on the modelled
    clock (the port's smoke round time)."""
    eng = ServeEngine(model, batch=8, replicas=3, clock="modeled",
                      execute=False, retries=2, scheduler="continuous",
                      steal_threshold=2,
                      autoscale=AutoscalePolicy(min_replicas=3,
                                                max_replicas=8))
    t_round = eng.t_round_model
    eng.autoscale = AutoscalePolicy(min_replicas=3, max_replicas=8,
                                    interval=t_round)
    rng = np.random.default_rng(0)
    rate = 3.0 * 3 * 8 / t_round
    t_arr = np.cumsum(rng.exponential(1.0 / rate, 160))
    reqs = [Request(rid=i, image=np.zeros((1, 1, 1), np.float32),
                    t_arrival=float(t_arr[i]),
                    cost=4.0 if i % 17 == 16 else 1.0) for i in range(160)]
    faults = FaultSchedule.mtbf(40 * t_round, 4 * t_round, 3, seed=2)
    trace, metrics = TraceRecorder(), MetricsRegistry()
    done, rep = eng.serve(reqs, faults=faults, trace=trace, metrics=metrics)
    return done, rep, trace, metrics


def test_chaos_autoscale_trace_reconciles_and_is_deterministic(model):
    done, rep, trace, metrics = _chaos_autoscale_run(model)
    assert rep.n_failures and rep.n_retries and rep.n_scale_up
    assert rep.n_steals and rep.n_done
    tdoc, mdoc = json.loads(trace.to_json()), json.loads(metrics.to_json())
    assert validate_trace(tdoc) == [] and validate_metrics(mdoc) == []
    assert reconcile(rep.to_dict(), trace=tdoc, metrics=mdoc) == []
    assert jobs.reconcile(rep.to_dict(), trace=tdoc, metrics=mdoc) == []
    _, rep2, trace2, metrics2 = _chaos_autoscale_run(model)
    assert trace2.to_json() == trace.to_json()
    assert metrics2.to_json() == metrics.to_json()
    assert json.dumps(rep2.to_dict()) == json.dumps(rep.to_dict())
    h = metrics.histograms["request_latency_seconds"]
    for q, ms in ((0.5, rep.p50_ms), (0.95, rep.p95_ms)):
        lo, hi = h.percentile_bounds(q)
        assert lo - 1e-12 <= ms / 1e3 <= hi + 1e-12


def test_reconcile_catches_a_miscount(model):
    _, rep, trace, metrics = _chaos_autoscale_run(model)
    d = rep.to_dict()
    d["n_steals"] += 1
    d["n_done"] += 1
    tdoc, mdoc = json.loads(trace.to_json()), json.loads(metrics.to_json())
    errs = reconcile(d, trace=tdoc, metrics=mdoc)
    assert errs == jobs.reconcile(d, trace=tdoc, metrics=mdoc)
    assert any("steal" in e for e in errs) and any(
        "serve_done_total" in e for e in errs)


@pytest.mark.parametrize("scheduler", ["gang", "continuous"])
def test_instrumentation_does_not_perturb_the_modelled_run(model,
                                                           scheduler):
    reqs = [Request(rid=i, image=np.zeros((1, 1, 1), np.float32),
                    t_arrival=0.0) for i in range(24)]

    def run(**rec):
        eng = ServeEngine(model, batch=8, replicas=2, clock="modeled",
                          execute=False, scheduler=scheduler)
        return eng.serve(list(reqs), **rec)[1].to_dict()
    assert run() == run(trace=TraceRecorder(), metrics=MetricsRegistry())


def test_gang_engine_trace_reconciles(model):
    eng = ServeEngine(model, batch=8, replicas=4, clock="modeled",
                      execute=False, retries=2)
    tr = eng.t_round_model
    reqs = [Request(rid=i, image=np.zeros((1, 1, 1), np.float32),
                    t_arrival=0.0) for i in range(48)]
    trace, metrics = TraceRecorder(), MetricsRegistry()
    _, rep = eng.serve(reqs, faults=FaultSchedule.at(tr * 0.5, tr * 2.5),
                       trace=trace, metrics=metrics)
    assert rep.n_failures == 1 and rep.n_retries > 0
    tdoc, mdoc = json.loads(trace.to_json()), json.loads(metrics.to_json())
    assert validate_trace(tdoc) == []
    assert reconcile(rep.to_dict(), trace=tdoc, metrics=mdoc) == []
    assert trace.count("round") >= rep.rounds and \
        trace.count("request") == rep.n_done


# -- drift ------------------------------------------------------------------

def test_drift_report_on_the_committed_fixture_equals_jax():
    doc = json.loads(FIXTURE.read_text())
    got, want = drift.drift_report(doc), jdrift.drift_report(doc)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert validate_drift(got, table=doc) == []
    assert got["n_measured"] == got["n_plans"] == 2
    m, jm = MetricsRegistry(), jobs.MetricsRegistry()
    drift.record_drift(m, got)
    jdrift.record_drift(jm, want)
    assert m.to_json() == jm.to_json()
    assert drift.DRIFT_RATIO_BUCKETS == jdrift.DRIFT_RATIO_BUCKETS
    bad = dict(got, rows=[dict(got["rows"][0], ratio=1.0)] + got["rows"][1:])
    assert validate_drift(bad, table=doc) == \
        jobs.validate_drift(bad, table=doc) != []


def _fake_timer(monkeypatch):
    """Stand-ins for the card's stopwatch: a fixed time a plan, counted as
    the real measurements are."""
    def conv(shape, plan, **kw):
        autotune._MEASURE_STATS["conv_measured"] += 1
        return 1e-4 * plan.tp / 128

    def gemm(shape, plan, **kw):
        autotune._MEASURE_STATS["gemm_measured"] += 1
        return 2e-5 * plan.ranks

    monkeypatch.setattr(autotune, "measure_plan", conv)
    monkeypatch.setattr(autotune, "measure_gemm_plan", gemm)
    monkeypatch.setattr(profiler, "backend_fingerprint",
                        lambda device=None: {
                            "platform": "cuda", "device": "stand-in",
                            "capability": "9.0", "sms": 132,
                            "timer": "cuda events"})


def test_compile_trace_and_the_ports_format3_drift(monkeypatch, tmp_path):
    _fake_timer(monkeypatch)
    profiler.clear_measure_cache()
    trace = TraceRecorder()
    c = compile_cnn(get_config("alexnet").smoke(), device="cpu",
                    measure=True, trace=trace)
    spans = [e for e in trace.to_chrome()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["sweep"] + ["measure"] * 8
    assert all(e["cat"] == "compile" for e in spans)
    assert all(e["tid"] == spans[0]["tid"] for e in spans)
    kinds = [e["args"]["kind"] for e in spans[1:]]
    assert kinds == ["conv"] * 5 + ["gemm"] * 3
    assert validate_trace(json.loads(trace.to_json())) == []
    doc = json.loads(c.plans().to_json())
    assert all(r["backend"] == "cuda:sm_90:132" for r in doc["conv"])
    rep = drift.drift_report(c.plans())
    assert rep["n_measured"] == 8 and rep["ratio"]["n"] == 8
    assert validate_drift(rep, table=doc) == []
    assert jobs.validate_drift(rep, table=doc) == []
    assert "stand-in" in drift.format_drift(rep)
    # the CLI over the saved table: report, metrics, validation
    path = c.save_plan(str(tmp_path / "plans.json"))
    out = tmp_path / "drift.json"
    assert drift.main([path, "--json", str(out), "--metrics",
                       str(tmp_path / "d.prom")]) == 0
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep))
    assert "plan_drift_ratio_bucket" in (tmp_path / "d.prom").read_text()
    from repro_torch.obs import validate as vmod
    assert vmod.main(["--drift", str(out), "--plan-table", path]) == 0
    doc["gemm"][0]["measured"]["t_measured"] *= 2
    (tmp_path / "edited.json").write_text(json.dumps(doc))
    assert vmod.main(["--drift", str(out), "--plan-table",
                      str(tmp_path / "edited.json")]) == 1


def test_plan_table_provenance_roundtrips_but_not_compared(tmp_path):
    a = PlanTable.from_rows([], [], provenance={"source": "test"})
    assert a == PlanTable.from_rows([], [])
    a.save(tmp_path / "p.json")
    back = PlanTable.load(tmp_path / "p.json")
    assert back.provenance == {"source": "test"}
    assert back.to_json() == a.to_json()


# -- the CLI's outputs ----------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--clock", "modeled"],
    ["--clock", "modeled", "--scheduler", "continuous", "--replicas", "2",
     "--rate", "1e6",
     "--steal-threshold", "1", "--retries", "2", "--autoscale",
     "--max-replicas", "3", "--scale-interval", "0.00001",
     "--straggler-every", "3", "--metrics-out", "METRICS.prom"],
    ["--replicas", "2", "--fail-at", "0.0001", "--recover-at", "0.0002",
     "--retries", "2", "--verify", "--no-kernels"]],
    ids=["gang_modelled", "continuous_autoscale", "measured_faults"])
def test_serve_cnn_cli_writes_outputs_that_validate(tmp_path, capsys, flags):
    t, m, r, d, p = (tmp_path / n for n in (
        "t.json", "m.json", "r.json", "d.json", "p.json"))
    flags = [str(tmp_path / f) if f.startswith("METRICS") else f
             for f in flags]
    if "--metrics-out" not in flags:
        flags += ["--metrics-out", str(m)]
    serve_cnn.main(["--smoke", "--device", "cpu", "--requests", "21",
                    "--batch", "4", "--trace-out", str(t), "--report-json",
                    str(r), "--drift-out", str(d), "--plan-out", str(p)]
                   + flags)
    out = capsys.readouterr().out
    tdoc, rdoc = json.loads(t.read_text()), json.loads(r.read_text())
    assert validate_trace(tdoc) == []
    assert rdoc["n_done"] + rdoc["n_failed"] + rdoc["n_rejected"] == 21
    if m.exists():
        mdoc = json.loads(m.read_text())
        assert validate_metrics(mdoc) == []
        assert reconcile(rdoc, trace=tdoc, metrics=mdoc) == []
    else:
        assert (tmp_path / "METRICS.prom").read_text().startswith("# HELP")
        assert reconcile(rdoc, trace=tdoc) == []
    assert validate_drift(json.loads(d.read_text()),
                          table=json.loads(p.read_text())) == []
    if "--scheduler" in flags:
        assert rdoc["scheduler"] == "continuous" and "continuous:" in out
        assert rdoc["n_steals"] + rdoc["n_scale_up"] > 0
    if "--verify" in flags:
        assert "statically verified" in out
    assert tdoc["otherData"]["scheduler"] == rdoc["scheduler"]
    assert {"compiled", "plan_provenance", "roofline_breakdown",
            "scheduler", "clock"} == set(tdoc["otherData"])
