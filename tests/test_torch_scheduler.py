"""The port's continuous scheduler (slice 7) against the JAX package's, on
the CPU.

The first half mirrors ``tests/test_scheduler.py`` on the port's engine
(``execute=False``, the modelled clock): a straggler holds only its own
slot, a queue skew gives exactly one steal, steals are off without a
retry budget, a scale-down drain drops and double-charges nothing, a
scale-up serves only after its modelled restore, and the edge cases end
well-formed; the engine's and the spec's validation errors, the
``AutoscalePolicy`` errors and the artifact's spec round trip equal
JAX's.

The second half holds the two loops against each other: for dp, pp and
hybrid, with work stealing and an autoscale policy on, the microbatch
count pinned and the round and restore times set alike on both engines
(the TPU and H100 cost models differ), under every fault scenario of
``tests/test_serve.py``: the completions ``(rid, pred, replica, version,
status, attempts)``, the report's counters, ``scale_events`` and
``occupancy`` equal JAX's, ``t_done`` and occupancy to 1e-12; and the
trace events (all but the process name) and the metrics snapshot equal
JAX's exactly. Executed on the CPU with steals and autoscaling, every
``ok`` prediction equals JAX's forward's argmax for its image (fp32
through the plain versions against JAX's oracles, as
``tests/test_torch_serve.py``; int8 bit for bit), and each admission
group is one forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.models.cnn import init_cnn_params as jax_init_cnn_params
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import TraceRecorder as JTraceRecorder
from repro.pipeline.artifact import spec_from_dict as jspec_from_dict
from repro.pipeline.artifact import spec_to_dict as jspec_to_dict
from repro.quant import calibrate_cnn as jax_calibrate_cnn
from repro.serve import engine as jengine
from repro.serve import router as jrouter
from repro.serve import scheduler as jscheduler
from repro_torch.configs import get_config
from repro_torch.core.config import SpecError
from repro_torch.launch.serve_cnn import synthetic_requests
from repro_torch.models.cnn import params_from_jax
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.pipeline import (AutoscalePolicy, ExecutionSpec, Placement,
                                  Precision, Serving, compile_cnn)
from repro_torch.pipeline.artifact import spec_from_dict, spec_to_dict
from repro_torch.quant import qparams_from_jax
from repro_torch.serve import FaultSchedule, Request, ServeEngine, router
from tests.test_torch_fleet import MODES, SCENARIOS, _faults_for, _same_stream


def _smoke():
    return get_config("alexnet").smoke()


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jax_get_config("alexnet").smoke()
    return jcfg, jax_init_cnn_params(jax.random.key(3), jcfg)


@pytest.fixture(scope="module")
def models(jax_model):
    """fp32 and int8 smoke AlexNet on the CPU (JAX's weights; int8
    calibrated by JAX on eight images and carried across)."""
    jcfg, jparams = jax_model
    cfg = _smoke()
    fp = compile_cnn(cfg, ExecutionSpec(serving=Serving(batch=8)),
                     params_from_jax(jparams, "cpu"), device="cpu")
    calib = np.random.default_rng(5).standard_normal(
        (8, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    jqp = jax_calibrate_cnn(jparams, jnp.asarray(calib), jcfg)
    q = compile_cnn(cfg, ExecutionSpec(precision=Precision(quant="int8"),
                                       serving=Serving(batch=8)),
                    qparams_from_jax(jqp, "cpu"), device="cpu")
    return fp, q, jqp


def _req(rid, t=0.0, cost=1.0):
    return Request(rid=rid, t_arrival=t, cost=cost,
                   image=np.zeros((1, 1, 1), np.float32))


def _engine(model, **kw):
    kw.setdefault("scheduler", "continuous")
    return ServeEngine(model, clock="modeled", execute=False, **kw)


# -- the slot lifecycle ---------------------------------------------------

def test_straggler_does_not_stall_coscheduled_slots(models):
    """A cost-4 straggler holds only its own slot: the three requests
    admitted beside it retire a whole round earlier; gang rounds would
    stall all four."""
    B = 4
    eng = _engine(models[0].model, batch=B)
    tr = eng.t_round_model
    done, _ = eng.serve([_req(i, cost=4.0 if i == 0 else 1.0)
                         for i in range(B)])
    t_done = {c.rid: c.t_done for c in done}
    assert all(c.status == "ok" for c in done)
    for rid in (1, 2, 3):
        assert t_done[rid] == pytest.approx(tr, rel=1e-6)
    assert t_done[0] == pytest.approx(4 * tr, rel=1e-6)
    gang = ServeEngine(models[0].model, batch=B, clock="modeled",
                       execute=False)
    gdone, _ = gang.serve([_req(i, cost=4.0 if i == 0 else 1.0)
                           for i in range(B)])
    assert all(c.t_done == pytest.approx(4 * tr, rel=1e-6) for c in gdone)


@pytest.mark.parametrize("retries,steals", [(1, 1), (0, 0)],
                         ids=["one_steal", "off_without_budget"])
def test_queue_skew_steals_once_and_only_with_budget(models, retries,
                                                     steals):
    """Five requests queued on replica 0, threshold 3: the idle replica
    steals exactly one (one a boundary; the depths never re-cross), which
    charges its budget but counts as a steal, not a retry; with no budget
    nothing is stolen and nothing fails."""
    eng = _engine(models[0].model, batch=1, replicas=2, steal_threshold=3,
                  retries=retries)
    for i in range(5):
        eng.router.queues[0].submit(_req(i))
    done, rep = eng.serve([])
    assert sorted(c.rid for c in done) == list(range(5))
    assert all(c.status == "ok" for c in done)
    assert rep.n_steals == steals and rep.n_retries == 0
    stolen = [c for c in done if c.attempts == 1]
    assert len(stolen) == steals
    assert all(c.replica == 1 for c in stolen)
    assert all(c.replica == 0 for c in done if c.attempts == 0)


def test_scale_down_drains_without_drop_or_double_charge(models):
    B = 4
    eng = _engine(models[0].model, batch=B, replicas=2, retries=0,
                  autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2,
                                            interval=1.0))
    eng.autoscale = dataclasses.replace(eng.autoscale,
                                        interval=eng.t_round_model / 4)
    done, rep = eng.serve([_req(i) for i in range(40)])
    assert sorted(c.rid for c in done) == list(range(40))
    assert all(c.status == "ok" and c.attempts == 0 for c in done)
    assert rep.n_scale_down >= 1 and rep.n_scale_up == 0
    assert rep.replicas_final == 2 - rep.n_scale_down
    assert [e["kind"] for e in rep.scale_events].count("down") == \
        rep.n_scale_down


def test_scale_up_charges_restore_latency(models):
    B = 4
    eng = _engine(models[0].model, batch=B, replicas=1, retries=0,
                  autoscale=AutoscalePolicy(min_replicas=1, max_replicas=2))
    tr = eng.t_round_model
    eng.autoscale = dataclasses.replace(eng.autoscale, interval=tr / 8)
    t_restore = eng._versions[eng._cur_version]["t_restore"]
    # arrivals at the one replica's capacity, outliving the restore
    n = int(8 * t_restore / tr) + 96
    done, rep = eng.serve([_req(i, t=i * tr / 4) for i in range(n)])
    assert sorted(c.rid for c in done) == list(range(n))
    ups = [e for e in rep.scale_events if e["kind"] == "up"]
    assert rep.n_scale_up == len(ups) >= 1
    served = [c for c in done if c.replica == ups[0]["replica"] != 0]
    assert served, "the scaled-up replica never served"
    assert min(c.t_done for c in served) > ups[0]["t"] + t_restore
    assert rep.replicas_final == 1 + rep.n_scale_up - rep.n_scale_down


def test_zero_requests_is_well_formed(models):
    done, rep = _engine(models[0].model, batch=4, replicas=2).serve([])
    assert done == [] and rep.n_done == 0 and rep.scheduler == "continuous"
    assert rep.n_steals == 0 and rep.scale_events == []
    assert rep.replicas_final == 2


def test_dead_fleet_fails_all_explicitly(models):
    eng = _engine(models[0].model, batch=4, retries=1)
    tr = eng.t_round_model
    for _ in range(2):
        done, rep = eng.serve([_req(i, t=i * tr / 8) for i in range(16)],
                              faults=FaultSchedule.at(tr * 0.5))
        assert sorted(c.rid for c in done) == list(range(16))
        assert rep.n_failures == 1
        assert any(c.status == "failed" for c in done)


def test_fail_recover_chaos_all_accounted(models):
    eng = _engine(models[0].model, batch=4, replicas=2, retries=2)
    tr, t_restore = eng.t_round_model, eng.t_restore_model
    # arrivals outlive the recovery (at 3 rounds + the modelled restore)
    done, rep = eng.serve([_req(i, t=i * t_restore / 16)
                           for i in range(48)],
                          faults=FaultSchedule.at(tr * 1.5, tr * 3.0))
    assert sorted(c.rid for c in done) == list(range(48))
    assert rep.n_failures == 1 and rep.n_recoveries == 1
    assert all(c.status == "ok" for c in done)


def _skewed_trace(n, rate, straggler_every=17, straggler_cost=4.0):
    rng = np.random.default_rng(7)
    t = np.cumsum(rng.exponential(1.0 / rate, n))
    return [_req(i, t=float(t[i]),
                 cost=straggler_cost
                 if i % straggler_every == straggler_every - 1 else 1.0)
            for i in range(n)]


def test_cb_beats_gang_p95_on_skewed_trace(models):
    B = 8
    gang = ServeEngine(models[0].model, batch=B, replicas=2,
                       clock="modeled", execute=False, retries=2)
    trace = _skewed_trace(64, rate=0.8 * 2 * B / gang.t_round_model)
    _, grep = gang.serve(list(trace))
    cb = _engine(models[0].model, batch=B, replicas=2, retries=2,
                 steal_threshold=1)
    cdone, crep = cb.serve(list(trace))
    assert sorted(c.rid for c in cdone) == list(range(64))
    assert crep.p95_ms < grep.p95_ms and crep.n_steals > 0


def test_continuous_schedule_is_deterministic(models):
    runs = []
    for _ in range(2):
        eng = _engine(models[0].model, batch=4, replicas=2, retries=2,
                      steal_threshold=1,
                      autoscale=AutoscalePolicy(min_replicas=1,
                                                max_replicas=4,
                                                interval=1e-4))
        done, rep = eng.serve(list(_skewed_trace(48, rate=1e5)))
        runs.append(([(c.rid, c.t_done, c.replica, c.status, c.attempts)
                      for c in done], rep.to_dict()))
    assert runs[0] == runs[1]


# -- validation -----------------------------------------------------------

ENGINE_ERRORS = {
    "scheduler": (dict(scheduler="nope", clock="modeled", execute=False),
                  "scheduler"),
    "measured": (dict(scheduler="continuous", clock="measured"), "modeled"),
    "steal_gang": (dict(clock="modeled", execute=False, steal_threshold=2),
                   "continuous"),
    "negative_steal": (dict(scheduler="continuous", clock="modeled",
                            execute=False, steal_threshold=-1), ">= 0"),
    "autoscale_gang": (dict(clock="modeled", execute=False,
                            autoscale={}), "continuous"),
    "autoscale_range": (dict(scheduler="continuous", clock="modeled",
                             execute=False,
                             autoscale=dict(min_replicas=2,
                                            max_replicas=4)),
                        "autoscale range"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_ERRORS))
def test_engine_validation_errors_equal_jax(models, case):
    kw, match = ENGINE_ERRORS[case]
    with pytest.raises(ValueError, match=match) as got:
        ServeEngine(models[0].model, **kw)
    with pytest.raises(ValueError, match=match) as want:
        jengine.ServeEngine(jax_get_config("alexnet").smoke(), [], **kw)
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]


SPEC_ERRORS = {
    "continuous_measured": lambda m: m.ExecutionSpec(
        serving=m.Serving(scheduler="continuous")),
    "steal_gang": lambda m: m.ExecutionSpec(
        serving=m.Serving(clock="modeled", steal_threshold=1)),
    "negative_steal": lambda m: m.ExecutionSpec(
        serving=m.Serving(clock="modeled", scheduler="continuous",
                          steal_threshold=-1)),
    "autoscale_gang": lambda m: m.ExecutionSpec(
        serving=m.Serving(clock="modeled",
                          autoscale=m.AutoscalePolicy())),
    "autoscale_range": lambda m: m.ExecutionSpec(
        placement=m.Placement(replicas=8),
        serving=m.Serving(clock="modeled", scheduler="continuous",
                          autoscale=m.AutoscalePolicy(max_replicas=4))),
}


@pytest.mark.parametrize("case", sorted(SPEC_ERRORS))
def test_spec_errors_name_the_jax_field(case):
    import repro_torch.pipeline as tpipe
    with pytest.raises(SpecError) as got:
        SPEC_ERRORS[case](tpipe)
    with pytest.raises(jpipe.SpecError) as want:
        SPEC_ERRORS[case](jpipe)
    assert got.value.field == want.value.field
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", [
    dict(min_replicas=0), dict(min_replicas=4, max_replicas=2),
    dict(interval=0.0), dict(cooldown=-1.0),
    dict(util_low=0.9, util_high=0.5), dict(window=0)],
    ids=["min0", "min_over_max", "interval", "cooldown", "util", "window"])
def test_autoscale_policy_errors_equal_jax(bad):
    with pytest.raises(ValueError) as got:
        AutoscalePolicy(**bad)
    with pytest.raises(ValueError) as want:
        jscheduler.AutoscalePolicy(**bad)
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(AutoscalePolicy()) == \
        dataclasses.asdict(jscheduler.AutoscalePolicy())


def test_spec_dict_roundtrip_with_autoscale_reads_jax_dicts():
    """The artifact's spec rebuilds the nested AutoscalePolicy, from the
    port's dict and from the JAX package's."""
    spec = ExecutionSpec(
        placement=Placement(replicas=2),
        serving=Serving(clock="modeled", execute=False,
                        scheduler="continuous", steal_threshold=2,
                        retries=1, autoscale=AutoscalePolicy(
                            min_replicas=1, max_replicas=6)))
    back = spec_from_dict(spec_to_dict(spec))
    assert back == spec and isinstance(back.serving.autoscale,
                                       AutoscalePolicy)
    jspec = jpipe.ExecutionSpec(
        placement=jpipe.Placement(replicas=2),
        serving=jpipe.Serving(clock="modeled", execute=False,
                              scheduler="continuous", steal_threshold=2,
                              retries=1, autoscale=jpipe.AutoscalePolicy(
                                  min_replicas=1, max_replicas=6)))
    assert jspec_from_dict(jspec_to_dict(jspec)) == jspec
    assert spec_from_dict(jspec_to_dict(jspec)).serving == spec.serving


# -- parity with the JAX loop ---------------------------------------------

def _cb_engines(model, mode, **kw):
    """The port's continuous engine and JAX's at the same placement, the
    JAX one's round and restore times set to the port's."""
    R, S, M = MODES[mode]
    jkw = dict(kw)
    if kw.get("autoscale") is not None:
        jkw["autoscale"] = jscheduler.AutoscalePolicy(
            **dataclasses.asdict(kw["autoscale"]))
    eng = ServeEngine(model, batch=8, replicas=R, pp_stages=S,
                      n_microbatches=M, clock="modeled", execute=False,
                      scheduler="continuous", **kw)
    jeng = jengine.ServeEngine(jax_get_config("alexnet").smoke(), [],
                               batch=8, replicas=R, pp_stages=S,
                               n_microbatches=M, clock="modeled",
                               execute=False, scheduler="continuous", **jkw)
    assert (jeng.mode, jeng.n_micro, jeng.router.n_replicas) == (
        eng.mode, eng.n_micro, eng.router.n_replicas)
    jeng.t_round_model = eng.t_round_model
    jeng.t_restore_model = eng.t_restore_model
    jeng._versions[0].update(t_round=eng.t_round_model,
                             t_restore=eng.t_restore_model)
    return eng, jeng


def _events(trace):
    """Every event but the process name (the port names itself)."""
    return [e for e in trace.to_chrome()["traceEvents"]
            if e["name"] != "process_name"]


def _counters(rep):
    return {k: getattr(rep, k) for k in (
        "mode", "scheduler", "replicas", "pp_stages", "batch", "n_done",
        "n_failed", "n_rejected", "n_retries", "n_failures", "n_recoveries",
        "degraded_rounds", "n_swapped", "rounds", "slo_violations",
        "n_steals", "n_scale_up", "n_scale_down", "replicas_final",
        "bubble_fraction")}


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_continuous_fleet_equals_jax(models, mode, scenario):
    fp, q, _ = models
    R = MODES[mode][0]
    probe = ServeEngine(fp.model, batch=8, replicas=R,
                        pp_stages=MODES[mode][1],
                        n_microbatches=MODES[mode][2], clock="modeled",
                        execute=False)
    tr = probe.t_round_model
    fs, jfs, kw, n, rate = _faults_for(scenario, tr, probe.t_restore_model,
                                       R)
    eng, jeng = _cb_engines(fp.model, mode, steal_threshold=1,
                            autoscale=AutoscalePolicy(
                                min_replicas=1, max_replicas=R + 2,
                                interval=tr / 2, window=16), **kw)
    if scenario == "hot_swap":
        at = tr * 0.5
        v = eng.hot_swap(q, at=at)
        assert jeng.hot_swap([], at=at) == v == 1
        jeng._versions[1].update(t_round=eng._versions[1]["t_round"],
                                 t_restore=eng._versions[1]["t_restore"])
        jeng._pending_swap["t_restore"] = eng._pending_swap["t_restore"]
    reqs, jreqs = _same_stream(n, rate=rate)
    for i in range(0, n, 5):            # stragglers, for the slots
        reqs[i].cost = jreqs[i].cost = 4.0
    trace, metrics = TraceRecorder(), MetricsRegistry()
    jtrace, jmetrics = JTraceRecorder(), JMetricsRegistry()
    done, rep = eng.serve(reqs, faults=fs, trace=trace, metrics=metrics)
    jdone, jrep = jeng.serve(jreqs, faults=jfs, trace=jtrace,
                             metrics=jmetrics)
    assert [(c.rid, c.pred, c.replica, c.version, c.status, c.attempts)
            for c in done] == [(c.rid, c.pred, c.replica, c.version,
                                c.status, c.attempts) for c in jdone]
    np.testing.assert_allclose([c.t_done for c in done],
                               [c.t_done for c in jdone], rtol=0, atol=1e-12)
    assert _counters(rep) == _counters(jrep)
    assert rep.scale_events == jrep.scale_events
    for k in ("occupancy", "utilization", "time_to_recover_s"):
        np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                   rtol=1e-12, atol=1e-15)
    assert rep.makespan_s == pytest.approx(jrep.makespan_s, abs=1e-12)
    assert _events(trace) == _events(jtrace)
    # as JSON: a run with no ok completion has NaN percentile gauges
    assert metrics.to_json() == jmetrics.to_json()
    assert sorted([c.rid for c in done] + [r.rid for r in
                                           eng.router.rejected]) == \
        list(range(n))


# -- executed on the CPU --------------------------------------------------

@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_executed_continuous_preds_equal_jax_argmax(jax_model, models,
                                                    monkeypatch, mode):
    """Steals, autoscaling and a fault on 2 -> up to 4 replicas: every ok
    prediction is JAX's forward's argmax for its image (fp32 against
    JAX's oracles; int8 bit for bit), and each admission group ran one
    forward of the model."""
    jcfg, jparams = jax_model
    fp, q, jqp = models
    c = fp if mode == "fp32" else q
    # a burst: 64 arrivals within a round, so the queues run deep, the
    # stragglers skew them and the fault lands on slots in flight
    reqs = synthetic_requests(64, jcfg.input_hw, jcfg.input_ch, 1e7)
    x = jnp.asarray(np.stack([r.image for r in reqs]))
    want = np.asarray(jnp.argmax(jpipe.compile_cnn(
        jcfg, jpipe.ExecutionSpec(
            precision=jpipe.Precision(quant="int8" if mode == "int8"
                                      else "none"), use_pallas=False),
        jqp if mode == "int8" else jparams).forward(x), -1)).tolist()
    for i in range(0, len(reqs), 5):
        reqs[i].cost = 4.0
    cc = compile_cnn(c.cfg, dataclasses.replace(c.spec, placement=Placement(
        replicas=2), serving=Serving(
            batch=8, clock="modeled", scheduler="continuous", retries=2,
            steal_threshold=1, autoscale=AutoscalePolicy(
                min_replicas=1, max_replicas=4, interval=1.0))),
        c.params, device="cpu")
    calls = []
    real = type(cc.model).forward
    monkeypatch.setattr(type(cc.model), "forward",
                        lambda self, x: calls.append(x.shape[0])
                        or real(self, x))
    tr = cc.engine.t_round_model
    cc.engine.autoscale = dataclasses.replace(cc.engine.autoscale,
                                              interval=tr / 2)
    rep = cc.serve(reqs, faults=FaultSchedule.at(tr * 4, tr * 8))
    done = sorted(rep.completions, key=lambda d: d.rid)
    assert [d.rid for d in done] == list(range(len(reqs)))
    assert rep.n_failures == 1 and rep.n_retries > 0
    assert rep.n_steals > 0 and rep.n_scale_up > 0, rep.summary()
    ok = [d for d in done if d.status == "ok"]
    assert ok and all(d.pred == want[d.rid] for d in ok)
    assert calls == [8] * cc.engine.admission_groups
    assert cc.engine.admission_groups >= -(-len(ok) // 8)


def test_slot_fn_pads_and_returns_the_forward_argmax(models):
    fp = models[0]
    eng = fp.engine
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((8, 67, 67, 3)).astype(np.float32)
    got = eng._slot_fn(0)(imgs)
    assert got.dtype == np.int64 and got.shape == (8,)
    np.testing.assert_array_equal(
        got, fp.forward(imgs).float().argmax(-1).numpy())


def test_router_pop_and_steal_equal_jax():
    def run(mod):
        r = mod.Router(2, 4)
        for i in range(6):
            r.queues[0].submit(mod.Request(
                rid=i, t_arrival=0.0, image=np.zeros((1, 1, 1))))
        out = [[q.rid for q in r.queues[0].pop(2)],
               r.steal(0).rid, r.steal(1), r.depths(),
               [q.rid for q in r.queues[0].pop(9)],
               r.queues[0].steal_tail()]
        return out
    assert run(router) == run(jrouter)
