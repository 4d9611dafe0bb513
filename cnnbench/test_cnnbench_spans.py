"""The readers of the program's host spans (``cnnbench/spans.py`` and the five
metrics that use it) on a hand-built span log and a device trace with known
busy intervals, on the CPU; their clock against the harness's on the card
(the ``card`` test at the end)."""
import random
import sys
from collections import deque

import pytest

from cnnbench import config, devtrace, harness, spans

SERVE = "vgg16_bf16.serve_b8"
READERS = ["pack_ms.serve", "h2d_ms.serve", "enqueue_ms.serve",
           "loop_ms.serve", "idle_in_serve.serve"]
US = 1000                                   # ns


def _round(call, rnd, t, parts):
    """One round's five spans from ``t`` (µs), each part's length given."""
    out = []
    for name, n in zip(("drain", "pack", "h2d", "enqueue", "sync"), parts):
        args = {"n_real": 1, "rids": [rnd]} if name == "drain" else None
        out.append((name, t * US, (t + n) * US, call, rnd, args))
        t += n
    return out


# two serve calls in the window, one after it. Call 0: serve [1000, 2000]
# µs, one round (600) and its report (50); call 1: serve [3000, 5000], two
# rounds and its report, 1600 in children.
LOG = ([("serve", 1000 * US, 2000 * US, 0, None, {"n": 1, "rounds": 1})]
       + _round(0, 0, 1100, (50, 50, 100, 200, 200))
       + [("report", 1800 * US, 1850 * US, 0, None, None),
          ("serve", 3000 * US, 5000 * US, 1, None, {"n": 2, "rounds": 2})]
       + _round(1, 0, 3100, (100, 50, 150, 100, 400))
       + _round(1, 1, 3900, (50, 50, 100, 200, 300))
       + [("report", 4700 * US, 4800 * US, 1, None, None),
          ("serve", 12000 * US, 13000 * US, 2, None, {"n": 1, "rounds": 1})]
       + _round(2, 0, 12100, (10, 10, 10, 10, 10)))
BUSY = [(1200, 1700), (3300, 3600), (4000, 4500), (6000, 7000)]
WANT = {"pack_ms.serve": 0.350 / 3, "h2d_ms.serve": 0.350 / 3,
        "enqueue_ms.serve": 0.500 / 3, "loop_ms.serve": (0.350 + 0.400) / 2,
        "idle_in_serve.serve": 100.0 * (500 + 1200) / 10000}


def _trace(busy=BUSY, t1=10000, host=(), marks=()):
    tr = devtrace.Trace.__new__(devtrace.Trace)
    tr.device = sorted((s * US, e * US, "k") for s, e in busy)
    tr.host = sorted((s * US, e * US, n) for s, e, n in host)
    tr.t0, tr.t1 = 0, t1 * US
    tr.phases = devtrace.PhaseLog()
    tr.phases.marks = [(t * US, n) for t, n in marks]
    return tr


@pytest.fixture
def log(monkeypatch):
    """The program's span log, replaced by ``LOG``."""
    from repro_torch.obs import trace as obs_trace
    monkeypatch.setattr(obs_trace, "_host_log", deque(LOG, maxlen=64))
    monkeypatch.setattr(obs_trace, "_host_dropped", 0)
    return obs_trace


def _read(name, ctx):
    return config.metric_reader(name)(ctx)


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_log(name, log, capsys):
    got = _read(name, {"trace": _trace(), "rounds": 3, "round_s": 1.5e-3})
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_a_trace(name, log):
    assert _read(name, {"trace": None, "rounds": 3, "round_s": 1e-3}) is None
    assert _read(name, {}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_spans(name, log):
    log._host_log.clear()
    assert _read(name, {"trace": _trace()}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_spans(name,
                                                           monkeypatch):
    """The parent of the spans: ``repro_torch.obs.trace`` lacks them."""
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace", None)
    assert _read(name, {"trace": _trace()}) is None


def test_spans_outside_the_window_are_left_out(log, capsys):
    ctx = {"trace": _trace(t1=4900)}       # cuts call 1's serve and report
    assert {s[3] for s in spans.window(ctx)} == {0, 1}
    assert _read("loop_ms.serve", ctx) == pytest.approx(0.350)
    assert spans.n_rounds(ctx["host_spans"]) == 3


def test_the_first_read_prints_the_count_and_the_dropped(log, capsys):
    log._host_dropped = 7
    ctx = {"trace": _trace(), "rounds": 3, "round_s": 1.5e-3}
    for name in READERS:
        _read(name, ctx)
    err = capsys.readouterr().err.splitlines()
    assert err == [err[0]] and err[0].startswith(
        "host spans: 19 in the window, 7 dropped;")


def test_idle_inside_on_touching_and_nested_intervals():
    assert spans.idle_inside([(0, 10)], []) == 10
    assert spans.idle_inside([(0, 10)], [(0, 10)]) == 0
    assert spans.idle_inside([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.idle_inside([(10, 20)], [(0, 12), (14, 15), (18, 40)]) == 5
    assert spans.idle_inside([(0, 5), (6, 8)], [(5, 6)]) == 7


@pytest.mark.parametrize("seed", range(6))
def test_idle_in_serve_never_exceeds_idle_share(seed, log):
    rng = random.Random(seed)
    cuts = sorted(rng.sample(range(1, 10000), 20))
    busy = [(a, b) for a, b in zip(cuts[::2], cuts[1::2])]
    ctx = {"trace": _trace(busy=busy)}
    inside = _read("idle_in_serve.serve", ctx)
    assert 0.0 <= inside <= _read("idle_share.serve", ctx) + 1e-9
    want = sum(b - a for a, b in ((1000, 2000), (3000, 5000))) - sum(
        max(0, min(e, b) - max(s, a)) for a, b in ((1000, 2000),
                                                   (3000, 5000))
        for s, e in busy)
    assert inside == pytest.approx(100.0 * want / 10000, abs=1e-9)


def test_clock_checks_on_a_hand_built_trace():
    host = [(1200, 1210, "cudaMemcpyAsync"), (1550, 1690, "cudaMemcpyAsync"),
            (3260, 3390, "cudaMemcpyAsync"), (3600, 3800, "cudaMemcpyAsync"),
            (3350, 3360, "cudaLaunchKernel"), (4010, 4090, "cudaMemcpyAsync"),
            (4200, 4210, "cudaMemcpyAsync")]       # the last in an enqueue
    marks = [(500, "waiting"), (990, "CompiledCNN.serve"), (2010, "harness"),
             (2500, "waiting"), (2980, "CompiledCNN.serve"),
             (5040, "harness")]
    tr = _trace(host=host, marks=marks)
    got = spans.clock_checks(tr, list(LOG[:-6]), round_ms=1.6 / 3)
    assert got["serve_over_phases"] == pytest.approx(3000 / (1020 + 2060))
    assert got["memcpy_inside"] == pytest.approx(5 / 6)
    assert got["memcpy_in_round"] == 1.0
    assert got["round_over_round_ms"] == pytest.approx(1.75 / 1.6)


def test_the_benchmark_names_the_five_readers_for_the_served_cell():
    bench = config.load_benchmark()
    served = {m["name"] for m in config.resolve(SERVE, bench)["per_layer"]}
    assert set(READERS) <= served
    for cell in bench["workloads"]:
        if cell["name"] != SERVE:
            names = {m["name"]
                     for m in config.resolve(cell["name"], bench)["per_layer"]}
            assert not set(READERS) & names


@pytest.mark.card
def test_span_clock_agrees_with_the_harness_on_the_card(cuda, monkeypatch,
                                                        capsys):
    """A traced run of the served cell: every new metric read, none
    dropped, the ``serve`` spans within 2 % of the harness's serve phases,
    every ``cudaMemcpy*`` runtime call inside a round's ``h2d``,
    ``enqueue`` or ``sync``, those in ``h2d`` and ``sync`` as many as the
    device's copies to and from the host, and a round's spans within 5 %
    of the engine's round clock."""
    from repro_torch.obs.trace import host_spans_dropped
    seen = []

    class Kept(devtrace.Trace):
        def __init__(self, *args):
            super().__init__(*args)
            seen.append(self)
    monkeypatch.setattr(devtrace, "Trace", Kept)
    dropped = host_spans_dropped()
    out = harness.run_cell(SERVE, 4294967311, 10.0, True)
    assert out["correct"] is True, out["compared"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(READERS) <= set(m), sorted(m)
    assert host_spans_dropped() == dropped
    assert m["idle_in_serve.serve"] <= m["idle_share.serve"]
    tr, = seen
    window = spans.window({"trace": tr})
    got = spans.clock_checks(tr, window, m["round_ms.serve"])
    print(got, file=sys.stderr)
    assert 0.98 <= got["serve_over_phases"] <= 1.0, got
    assert got["memcpy_in_round"] >= 0.99, got
    assert abs(got["round_over_round_ms"] - 1.0) <= 0.05, got
    host_copies = sum(c for name, (c, _) in tr.by_name().items()
                      if name.startswith(("Memcpy HtoD", "Memcpy DtoH")))
    memcpy = [(s, e) for s, e, n in tr.host
              if n.startswith("cudaMemcpy") and tr.t0 <= s and e <= tr.t1]
    assert round(got["memcpy_inside"] * len(memcpy)) == host_copies
