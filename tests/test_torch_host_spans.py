"""The gang serving loop's host spans (``repro_torch.obs.trace``) on the CPU.

A measured-clock ``serve`` nests each round's ``drain``, ``pack``, ``h2d``,
``enqueue`` and ``sync`` in order inside its ``serve`` span, the ``report``
after the rounds, all on the epoch clock between two ``time.time_ns()``
reads; ``host_spans`` cuts the process-wide log to a window and its bound
drops the oldest spans and counts them; the recorder exports them as a
second process that ``validate_trace`` accepts and ``reconcile`` ignores.
No span is logged when neither a recorder is given nor a torch profile
runs, and a profile alone turns them on. A modelled-clock trace is byte
for byte the committed one written before the host spans existed, and a
serve without a recorder builds no event and serves what a recorded serve
serves.
"""
import json
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.obs import (MetricsRegistry, TraceRecorder, reconcile,
                             validate_trace)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import (HOST_PID, HOST_PROCESS, HostCall,
                                   host_call, host_spans, host_spans_dropped)
from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn
from repro_torch.serve import FaultSchedule, Request, ServeEngine

FIXTURES = Path(__file__).resolve().parent / "fixtures"
ROUND = ("drain", "pack", "h2d", "enqueue", "sync")
N_REQ = 10


@pytest.fixture(scope="module")
def compiled():
    c = compile_cnn(get_config("alexnet").smoke(),
                    ExecutionSpec(serving=Serving(batch=4)), device="cpu")
    c.serve(_requests(c.cfg, 4))        # the warm-up pass, outside the tests
    return c


def _requests(cfg, n, t_arrival=0.0):
    rng = np.random.default_rng(7)
    return [Request(rid=i, image=rng.standard_normal(
        (cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32),
        t_arrival=t_arrival) for i in range(n)]


@pytest.fixture(scope="module")
def served(compiled):
    """One measured serve of 10 requests into a recorder: the clock read
    before and after, the report and the recorder."""
    trace = TraceRecorder()
    t0 = time.time_ns()
    rep = compiled.serve(_requests(compiled.cfg, N_REQ), trace=trace)
    t1 = time.time_ns()
    return t0, t1, rep, trace


def _call(served):
    t0, t1, _, _ = served
    return host_spans(t0, t1)


def test_the_call_has_one_serve_span_and_one_report(served):
    spans = _call(served)
    rep = served[2]
    serve = [s for s in spans if s[0] == "serve"]
    assert len(serve) == 1 and serve[0][5] == {"n": N_REQ,
                                                "rounds": rep.rounds}
    assert [s[0] for s in spans].count("report") == 1
    assert {s[3] for s in spans} == {serve[0][3]}
    assert len(spans) == 2 + len(ROUND) * rep.rounds


@pytest.mark.parametrize("name", ROUND + ("report",))
def test_every_child_nests_inside_the_serve_span(served, name):
    spans = _call(served)
    (_, a, b, _, _, _), = [s for s in spans if s[0] == "serve"]
    kids = [s for s in spans if s[0] == name]
    assert kids and all(a <= s[1] <= s[2] <= b for s in kids)


def test_each_round_runs_its_spans_in_order(served):
    spans = _call(served)
    rep = served[2]
    report, = [s for s in spans if s[0] == "report"]
    for r in range(rep.rounds):
        got = [s for s in spans if s[4] == r]
        assert [s[0] for s in got] == list(ROUND)
        assert all(p[2] <= q[1] for p, q in zip(got, got[1:]))
        assert got[-1][2] <= report[1]
    assert report[4] is None


def test_drains_carry_the_requests_they_took(served):
    drains = [s for s in _call(served) if s[0] == "drain"]
    assert sum(s[5]["n_real"] for s in drains) == N_REQ
    assert sorted(r for s in drains for r in s[5]["rids"]) == list(
        range(N_REQ))


def test_spans_lie_between_the_clock_reads_around_the_call(served):
    t0, t1, _, _ = served
    spans = _call(served)
    assert spans and all(t0 <= s[1] <= s[2] <= t1 for s in spans)
    assert spans == [s for s in host_spans() if t0 <= s[1] and s[2] <= t1]


def test_the_recorder_exports_the_host_process(served):
    _, _, rep, trace = served
    doc = json.loads(trace.to_json())
    assert validate_trace(doc) == []
    assert reconcile(rep.to_dict(), trace=doc) == []
    host = [e for e in doc["traceEvents"] if e["pid"] == HOST_PID]
    assert host[0]["args"] == {"name": HOST_PROCESS}
    xs = [e for e in host if e["ph"] == "X"]
    assert len(xs) == len(_call(served)) and xs[0]["name"] == "serve"
    assert all(e["cat"] == "host" and e["ts"] > 1e15 for e in xs)
    assert trace.count("drain") == 0 and trace.count("request") == N_REQ


def test_validate_trace_catches_a_host_span_out_of_order(served):
    doc = json.loads(served[3].to_json())
    xs = [e for e in doc["traceEvents"]
          if e["pid"] == HOST_PID and e["ph"] == "X"]
    xs[1]["ts"] = xs[0]["ts"] - 1.0
    assert any("not monotone" in e for e in validate_trace(doc))


def _fake_clock(monkeypatch, start=100):
    ticks = iter(range(start, 10 ** 6, 10))
    monkeypatch.setattr(obs_trace, "now_ns", lambda: next(ticks))


def test_host_spans_cut_to_the_window(monkeypatch):
    monkeypatch.setattr(obs_trace, "_host_log", deque(maxlen=16))
    _fake_clock(monkeypatch)
    hc = HostCall()                                 # t0 = 100
    for name in ("a", "b", "c"):                    # [100, 110], ...
        hc.span(name, obs_trace.now_ns())
    assert [(s[1], s[2]) for s in host_spans()] == [
        (110, 120), (130, 140), (150, 160)]
    assert [s[0] for s in host_spans(110, 140)] == ["a", "b"]
    assert [s[0] for s in host_spans(111, 160)] == ["b", "c"]
    assert [s[0] for s in host_spans(None, 159)] == ["a", "b"]
    assert host_spans(121, 129) == []


def test_the_bound_drops_the_oldest_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(obs_trace, "_host_log", deque(maxlen=3))
    monkeypatch.setattr(obs_trace, "_host_dropped", 0)
    _fake_clock(monkeypatch)
    hc = HostCall()
    for i in range(5):
        hc.rnd = i
        hc.span("drain", obs_trace.now_ns())
    assert [s[4] for s in host_spans()] == [2, 3, 4]
    assert host_spans_dropped() == 2


def test_a_recorder_keeps_its_calls_spans_whatever_the_bound(monkeypatch):
    monkeypatch.setattr(obs_trace, "_host_log", deque(maxlen=1))
    monkeypatch.setattr(obs_trace, "_host_dropped", 0)
    trace = TraceRecorder()
    hc = HostCall(trace)
    for name in ("a", "b"):
        hc.span(name, obs_trace.now_ns())
    assert len(host_spans()) == 1 and host_spans_dropped() == 1
    names = [e["name"] for e in trace.to_chrome()["traceEvents"]
             if e["pid"] == HOST_PID and e["ph"] == "X"]
    assert names == ["a", "b"]


def test_no_span_without_a_recorder_or_a_profile(compiled):
    assert not torch._C._autograd._profiler_enabled()
    assert host_call(None) is None and host_call(TraceRecorder()) is not None
    before = host_spans()
    rep = compiled.serve(_requests(compiled.cfg, N_REQ))
    assert rep.n_done == N_REQ and host_spans() == before


def test_a_torch_profile_turns_the_spans_on(compiled):
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        rep = compiled.serve(_requests(compiled.cfg, N_REQ))
    spans = host_spans(t0, time.time_ns())
    assert len(spans) == 2 + len(ROUND) * rep.rounds


def test_a_modelled_serve_logs_no_host_span(compiled):
    eng = ServeEngine(compiled.model, batch=4, clock="modeled",
                      execute=False)
    before = host_spans()
    eng.serve(_requests(compiled.cfg, N_REQ), trace=TraceRecorder())
    assert host_spans() == before


# -- the modelled clock's export, byte for byte ----------------------------

def _fixture_requests():
    rng = np.random.default_rng(5)
    t = np.cumsum(rng.exponential(2e-4, 20))
    return [Request(rid=i, image=np.zeros((1, 1, 1), np.float32),
                    t_arrival=float(t[i])) for i in range(20)]


def _modelled_trace(model, scheduler):
    kw = dict(steal_threshold=1) if scheduler == "continuous" else {}
    eng = ServeEngine(model, batch=4, replicas=2, clock="modeled",
                      execute=False, retries=1, scheduler=scheduler, **kw)
    tr = eng.t_round_model
    faults = FaultSchedule.at(tr * 0.5, tr * 2.5) if scheduler == "gang" \
        else None
    trace = TraceRecorder()
    eng.serve(_fixture_requests(), faults=faults, trace=trace)
    return trace.to_json()


@pytest.mark.parametrize("scheduler", ["gang", "continuous"])
def test_a_modelled_trace_is_byte_identical_to_the_committed_one(
        compiled, scheduler):
    want = (FIXTURES / f"serve_trace_{scheduler}_modelled.json").read_text()
    assert _modelled_trace(compiled.model, scheduler) == want


# -- serving without a recorder ---------------------------------------------

def _engine(model, scheduler):
    return ServeEngine(model, batch=4, replicas=2, clock="modeled",
                       retries=1, scheduler=scheduler)


@pytest.mark.parametrize("scheduler", ["gang", "continuous"])
def test_no_recorder_serves_what_a_recorder_serves(compiled, scheduler):
    reqs = _requests(compiled.cfg, N_REQ)
    done, rep = _engine(compiled.model, scheduler).serve(list(reqs))
    tdone, trep = _engine(compiled.model, scheduler).serve(
        list(reqs), trace=TraceRecorder(), metrics=MetricsRegistry())
    assert done == tdone and rep.to_dict() == trep.to_dict()
    assert all(c.pred >= 0 for c in done)


@pytest.mark.parametrize("scheduler", ["gang", "continuous"])
def test_no_recorder_builds_no_event(compiled, scheduler, monkeypatch):
    def built(*args, **kwargs):
        raise AssertionError("an event was built without a recorder")
    monkeypatch.setattr(TraceRecorder, "__init__", built)
    monkeypatch.setattr(TraceRecorder, "_emit", built)
    _, rep = _engine(compiled.model, scheduler).serve(
        _requests(compiled.cfg, N_REQ))
    assert rep.n_done == N_REQ
