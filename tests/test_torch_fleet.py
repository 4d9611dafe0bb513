"""The port's fleet (slice 6) against the JAX package's, on the CPU.

``FaultSchedule`` (the same event lists from numpy's generator, the same
validation errors), the ``Router``'s alive-mask dispatch, evacuation and
drains, the engine's super-batch packing, and the gang loop on the
modelled clock with ``execute=False``: for dp, pp and hybrid, with the
microbatch count pinned and the round and restore times set alike on
both engines (the TPU and H100 cost models differ), the completions
``(rid, pred, t_done, replica, version, status, attempts)`` and the
report's counters equal JAX's, ``t_done`` to 1e-12 s, under every fault
scenario of ``tests/test_serve.py``. Executed on the CPU, every mode's
predictions equal JAX's single-device forward's argmax (the plain
versions against JAX's oracles, as ``tests/test_torch_serve.py``), and
the pp stage schedule's int8 logits equal the int8 forward's and JAX's
bit for bit. The fleet flags of ``launch.serve_cnn`` run end to end.
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.models.cnn import init_cnn_params as jax_init_cnn_params
from repro.quant import calibrate_cnn as jax_calibrate_cnn
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import router as jrouter
from repro_torch.configs import get_config
from repro_torch.core.config import SpecError
from repro_torch.launch.serve_cnn import main, synthetic_requests
from repro_torch.models.cnn import params_from_jax
from repro_torch.obs import MetricsRegistry
from repro_torch.pipeline import (ExecutionSpec, Placement, Precision,
                                  Serving, compile_cnn)
from repro_torch.quant import qparams_from_jax
from repro_torch.serve import engine, faults, router
from repro_torch.serve.engine import ServeEngine

MODES = {"dp": (4, 1, 0), "pp": (1, 2, 4), "hybrid": (2, 2, 2)}


def _smoke():
    return get_config("alexnet").smoke()


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jax_get_config("alexnet").smoke()
    return jcfg, jax_init_cnn_params(jax.random.key(3), jcfg)


@pytest.fixture(scope="module")
def models(jax_model):
    """fp32 and int8 smoke AlexNet on the CPU (JAX's weights; int8
    calibrated on eight images)."""
    jcfg, jparams = jax_model
    cfg = _smoke()
    fp = compile_cnn(cfg, ExecutionSpec(serving=Serving(batch=8)),
                     params_from_jax(jparams, "cpu"), device="cpu")
    calib = np.random.default_rng(5).standard_normal(
        (8, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)
    q = compile_cnn(cfg, ExecutionSpec(precision=Precision(quant="int8"),
                                       serving=Serving(batch=8)),
                    qparams_from_jax(jax_calibrate_cnn(
                        jparams, jnp.asarray(calib), jcfg), "cpu"),
                    device="cpu")
    return fp, q


# -- the fault schedule ---------------------------------------------------

def _events(schedule, n):
    return [(e.t, e.replica, e.kind)
            for e in itertools.islice(iter(schedule), n)]


@pytest.mark.parametrize("seed", [0, 5, 7])
def test_mtbf_stream_equals_jax(seed):
    assert _events(faults.FaultSchedule.mtbf(3.0, 1.0, 4, seed=seed), 40) \
        == _events(jfaults.FaultSchedule.mtbf(3.0, 1.0, 4, seed=seed), 40)


def test_deterministic_schedules_equal_jax():
    got = faults.FaultSchedule.at(0.5, 1.25, replica=2)
    want = jfaults.FaultSchedule.at(0.5, 1.25, replica=2)
    assert _events(got, 9) == _events(want, 9) and len(got) == len(want)
    evs = [(0.3, 1, "recover"), (0.1, 0, "fail"), (0.3, 0, "fail")]
    got = faults.FaultSchedule([faults.FaultEvent(*e) for e in evs])
    want = jfaults.FaultSchedule([jfaults.FaultEvent(*e) for e in evs])
    assert _events(got, 9) == _events(want, 9)
    assert repr(got) == repr(want)


VALIDATION = {
    "kind": lambda m: m.FaultEvent(t=0.1, replica=0, kind="explode"),
    "t": lambda m: m.FaultEvent(t=-1.0, replica=0, kind="fail"),
    "replica": lambda m: m.FaultEvent(t=0.0, replica=-1, kind="fail"),
    "recover_before_fail": lambda m: m.FaultSchedule.at(1.0, 0.5),
    "both": lambda m: m.FaultSchedule(
        [m.FaultEvent(t=1.0, replica=0, kind="fail")], mtbf=1.0, mttr=0.5,
        n_replicas=2),
    "no_mttr": lambda m: m.FaultSchedule.mtbf(1.0, 0.0, 2),
    "negative": lambda m: m.FaultSchedule(mtbf=-1.0),
    "out_of_fleet": lambda m: m.FaultSchedule.at(1.0, replica=7)
    .validate_for(4),
    "mtbf_out_of_fleet": lambda m: m.FaultSchedule.mtbf(1.0, 0.5, 6)
    .validate_for(4),
    "len_of_mtbf": lambda m: len(m.FaultSchedule.mtbf(1.0, 0.5, 2)),
}


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_fault_validation_errors_equal_jax(case):
    with pytest.raises((ValueError, TypeError)) as got:
        VALIDATION[case](faults)
    with pytest.raises((ValueError, TypeError)) as want:
        VALIDATION[case](jfaults)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# -- the router -----------------------------------------------------------

def _req(mod, rid, t=0.0, hw=4):
    return mod.Request(rid=rid, t_arrival=t,
                       image=np.full((hw, hw, 3), rid, np.float32))


def _router_trace(mod):
    """Dispatch, evacuate and drain under a changing alive mask; every
    observable as plain data."""
    r = mod.Router(3, 2, max_queue=3)
    out = []
    alive = [True, False, True]
    for i in range(8):
        out.append(("dispatch", i, r.dispatch(_req(mod, i), alive),
                    r.last_replica, r.depths()))
    out.append(("evacuate", [q.rid for q in r.evacuate(2)], r.depths()))
    alive = [False, True, True]
    for i in range(8, 11):
        out.append(("dispatch", i, r.dispatch(_req(mod, i), alive),
                    r.last_replica, r.depths()))
    for mask in (alive, None):
        out.append(("drain", [
            (rep, [q.rid for q in take], None if imgs is None
             else np.asarray(imgs)[:, 0, 0, 0].tolist(), n)
            for rep, take, imgs, n in r.drain_round(mask)]))
    out.append(("rejected", [q.rid for q in r.rejected], r.backlog()))
    with pytest.raises(RuntimeError, match="no alive replica"):
        r.dispatch(_req(mod, 99), [False] * 3)
    return out


def test_router_with_alive_mask_equals_jax():
    assert _router_trace(router) == _router_trace(jrouter)


# -- the engine on the modelled clock -------------------------------------

def _engines(model, mode, **kw):
    """The port's engine and JAX's at the same placement, the JAX one's
    round and restore times set to the port's."""
    R, S, M = MODES[mode]
    eng = ServeEngine(model, batch=8, replicas=R, pp_stages=S,
                      n_microbatches=M, clock="modeled", execute=False, **kw)
    jeng = jengine.ServeEngine(jax_get_config("alexnet").smoke(), [],
                               batch=8, replicas=R, pp_stages=S,
                               n_microbatches=M, clock="modeled",
                               execute=False, **kw)
    assert (jeng.mode, jeng.n_micro, jeng.mb) == (eng.mode, eng.n_micro,
                                                  eng.mb)
    jeng.t_round_model = eng.t_round_model
    jeng.t_restore_model = eng.t_restore_model
    jeng._versions[0].update(t_round=eng.t_round_model,
                             t_restore=eng.t_restore_model)
    return eng, jeng


def _same_stream(n, *, rate=None, hw=67):
    port, jax_ = [], []
    for i in range(n):
        t = 0.0 if rate is None else (i + 1) / rate
        port.append(_req(router, i, t, hw))
        jax_.append(_req(jrouter, i, t, hw))
    return port, jax_


def _faults_for(scenario, t_round, t_restore, R):
    """(port schedule, JAX schedule, engine keywords, requests, rate)."""
    def both(make):
        return make(faults), make(jfaults)
    if scenario == "fail_mid_burst":
        return both(lambda m: m.FaultSchedule.at(t_round * 0.5)) + (
            dict(retries=2), 96, None)
    if scenario == "fail_then_recover":
        return both(lambda m: m.FaultSchedule.at(
            t_round * 0.5, t_round * 2.5, replica=R - 1)) + (
            dict(retries=3), 200, None)
    if scenario == "retries_exhausted":
        return both(lambda m: m.FaultSchedule.at(t_round * 0.5)) + (
            dict(retries=0), 96, None)
    if scenario == "backoff":
        return both(lambda m: m.FaultSchedule.at(t_round * 0.5)) + (
            dict(retries=2, backoff=10 * t_round), 96, None)
    if scenario == "fleet_death":
        return both(lambda m: m.FaultSchedule(
            [m.FaultEvent(t=t_round * 0.5, replica=r, kind="fail")
             for r in range(R)])) + (dict(retries=1), 96, None)
    if scenario == "mtbf":
        return both(lambda m: m.FaultSchedule.mtbf(
            t_round * 3, t_round, R, seed=7)) + (dict(retries=5), 300, None)
    if scenario == "arrivals_slo_max_queue":
        return (None, None, dict(retries=1, slo=2 * t_round, max_queue=5),
                120, 3.0 / t_round)
    if scenario == "hot_swap":
        # arrivals over twice the roll, so both versions serve
        return None, None, {}, 200, 200 / (2 * R * t_restore)
    raise AssertionError(scenario)


SCENARIOS = ["fail_mid_burst", "fail_then_recover", "retries_exhausted",
             "backoff", "fleet_death", "mtbf", "arrivals_slo_max_queue",
             "hot_swap"]


def _completions(done):
    return [(c.rid, c.pred, c.replica, c.version, c.status, c.attempts)
            for c in done]


def _counters(rep):
    return {k: getattr(rep, k) for k in (
        "mode", "replicas", "pp_stages", "batch", "n_done", "n_failed",
        "n_rejected", "n_retries", "n_failures", "n_recoveries",
        "degraded_rounds", "n_swapped", "rounds", "slo_violations",
        "bubble_fraction")}


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_modelled_fleet_equals_jax(models, mode, scenario):
    fp, q = models
    R = MODES[mode][0]
    probe = ServeEngine(fp.model, batch=8, replicas=R,
                        pp_stages=MODES[mode][1],
                        n_microbatches=MODES[mode][2], clock="modeled",
                        execute=False)
    fs, jfs, kw, n, rate = _faults_for(scenario, probe.t_round_model,
                                       probe.t_restore_model, R)
    eng, jeng = _engines(fp.model, mode, **kw)
    if scenario == "hot_swap":
        at = eng.t_round_model * 0.5
        v = eng.hot_swap(q, at=at)
        assert jeng.hot_swap([], at=at) == v == 1
        jeng._versions[1].update(t_round=eng._versions[1]["t_round"],
                                 t_restore=eng._versions[1]["t_restore"])
        jeng._pending_swap["t_restore"] = eng._pending_swap["t_restore"]
    reqs, jreqs = _same_stream(n, rate=rate)
    metrics = MetricsRegistry()
    done, rep = eng.serve(reqs, faults=fs, metrics=metrics)
    jdone, jrep = jeng.serve(jreqs, faults=jfs)
    assert _completions(done) == _completions(jdone)
    np.testing.assert_allclose([c.t_done for c in done],
                               [c.t_done for c in jdone], rtol=0, atol=1e-12)
    assert _counters(rep) == _counters(jrep)
    for k in ("utilization", "time_to_recover_s"):
        np.testing.assert_allclose(getattr(rep, k), getattr(jrep, k),
                                   rtol=1e-12, atol=1e-15)
    assert rep.makespan_s == pytest.approx(jrep.makespan_s, abs=1e-12)
    # every request ends as exactly one completion or one rejection
    assert sorted([c.rid for c in done] + [r.rid for r in
                                           eng.router.rejected]) == \
        list(range(n))
    assert metrics.value("serve_done_total") == rep.n_done
    assert metrics.value("serve_failed_total") == rep.n_failed
    if scenario == "hot_swap":
        # one replica rolls before its first round: the fleet is down
        assert rep.n_swapped == R and {c.version for c in done} == (
            {0, 1} if R > 1 else {1})
        assert eng.model is q.model and eng.dtype == "int8"


def test_pp_busy_accounting_counts_padded_replicas(models):
    """Nine requests over 2 replicas x 2 stages: replica 1's stages
    compute a whole padded round for its one request, as JAX credits."""
    eng, jeng = _engines(models[0].model, "hybrid")
    reqs, jreqs = _same_stream(9)
    _, rep = eng.serve(reqs)
    _, jrep = jeng.serve(jreqs)
    assert rep.utilization == pytest.approx(jrep.utilization, rel=1e-12)
    assert rep.utilization[0] == pytest.approx(rep.utilization[1])
    assert rep.utilization[1] > 0.99


def test_hot_swap_registration_is_exclusive_and_checked(models):
    fp, q = models
    eng = ServeEngine(fp.model, batch=8, replicas=2, clock="modeled",
                      execute=False)
    eng.hot_swap(q)
    with pytest.raises(RuntimeError, match="already registered"):
        eng.hot_swap(q)
    eng = ServeEngine(fp.model, batch=8, clock="modeled", execute=False)
    other = compile_cnn(dataclasses.replace(_smoke(), n_classes=10),
                        device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        eng.hot_swap(other)


def test_restore_model_and_params_bytes_equal_jax(jax_model, models):
    _, jparams = jax_model
    fp, q = models
    assert engine.params_nbytes(fp.model) == jengine.params_nbytes(jparams)
    assert engine.params_nbytes(q.model) == sum(
        t.numel() * t.element_size() for ql in q.params.layers
        if ql is not None for t in (ql.w_q, ql.w_scale, ql.scale, ql.b)
        if t is not None)
    for nb in (0, 12345, 553_000_000):
        assert engine.restore_latency_model(nb) == \
            jengine.restore_latency_model(nb)
    assert [k for k, _ in engine.SERVE_COUNTERS] == \
        [k for k, _ in jengine.SERVE_COUNTERS]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pack_and_unpack_equal_jax(models, mode):
    eng, jeng = _engines(models[0].model, mode)
    rng = np.random.default_rng(1)
    items = [(r, [], None if r == 1 else rng.standard_normal(
        (8, 67, 67, 3)).astype(np.float32), 0) for r in range(eng.replicas)]
    packed = eng._pack(items)
    np.testing.assert_array_equal(packed, np.asarray(jeng._pack(items)))
    preds = np.arange(packed.shape[0])
    np.testing.assert_array_equal(eng._unpack_preds(preds),
                                  jeng._unpack_preds(preds))


# -- executed on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def jax_preds(jax_model):
    jcfg, jparams = jax_model
    reqs = synthetic_requests(37, jcfg.input_hw, jcfg.input_ch, 400.0)
    x = np.stack([r.image for r in reqs])
    fwd = jpipe.compile_cnn(jcfg, jpipe.ExecutionSpec(use_pallas=False),
                            jparams).forward(jnp.asarray(x))
    return reqs, np.asarray(jnp.argmax(fwd, -1)).tolist()


@pytest.mark.parametrize("clock", ["measured", "modeled"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_executed_fleet_preds_equal_jax_forward(jax_model, jax_preds, mode,
                                                clock):
    _, jparams = jax_model
    reqs, want = jax_preds
    R, S, M = MODES[mode]
    c = compile_cnn(_smoke(), ExecutionSpec(
        placement=Placement(replicas=R, pp_stages=S, microbatches=M),
        serving=Serving(batch=8, clock=clock, retries=2)),
        params_from_jax(jparams, "cpu"), device="cpu")
    t_round = c.engine.t_round_model
    rep = c.serve(reqs, faults=faults.FaultSchedule.at(
        t_round * 1.5, t_round * 4, replica=0) if clock == "modeled"
        else None)
    done = sorted(rep.completions, key=lambda d: d.rid)
    assert [d.rid for d in done] == list(range(len(reqs)))
    assert all(d.status == "ok" for d in done)
    assert [d.pred for d in done] == want
    assert rep.mode == mode and c.mode == mode


@pytest.mark.parametrize("mode", ["pp", "hybrid"])
def test_stage_schedule_int8_logits_equal_the_forward_and_jax(jax_model,
                                                              mode):
    jcfg, jparams = jax_model
    x = np.random.default_rng(2).standard_normal(
        (8, jcfg.input_hw, jcfg.input_hw, jcfg.input_ch)).astype(np.float32)
    jqp = jax_calibrate_cnn(jparams, jnp.asarray(x), jcfg)
    want = np.asarray(jpipe.compile_cnn(
        jcfg, jpipe.ExecutionSpec(precision=jpipe.Precision(quant="int8"),
                                  use_pallas=False), jqp).forward(
        jnp.asarray(x)))
    R, S, M = MODES[mode]
    c = compile_cnn(_smoke(), ExecutionSpec(
        precision=Precision(quant="int8"),
        placement=Placement(replicas=R, pp_stages=S, microbatches=M)),
        qparams_from_jax(jqp, "cpu"), device="cpu")
    assert c.n_stages == S and sorted(g for st in c.stages for g in st) == \
        c.model.groups
    got = c.forward(x)
    with torch.inference_mode():
        fold = c.model(torch.from_numpy(x))
    assert torch.equal(got, fold)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not divide"):
        c.forward(x[:3])


def test_stage_schedule_fp32_and_bf16_equal_the_fold():
    cfg = _smoke()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32))
    for dtype in ("float32", "bfloat16"):
        c = compile_cnn(cfg, ExecutionSpec(
            precision=Precision(dtype=dtype),
            placement=Placement(pp_stages=3, microbatches=4)), device="cpu")
        with torch.inference_mode():
            fold = c.model(x.to(c.model.in_dtype))
        assert torch.equal(c.forward(x), fold)
        assert c.plans().provenance["stages"] == {
            "pp_stages": 3, "microbatches": 4, "microbatch_rows": 2,
            "microbatch_plans": "serving batch 8"}


# -- the spec and the CLI -------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda m: m.ExecutionSpec(placement=m.Placement(microbatches=2)),
    lambda m: m.ExecutionSpec(placement=m.Placement(pp_stages=2,
                                                    microbatches=3)),
    lambda m: m.ExecutionSpec(serving=m.Serving(retries=-1)),
    lambda m: m.ExecutionSpec(serving=m.Serving(backoff=-1.0, retries=1)),
    lambda m: m.ExecutionSpec(serving=m.Serving(backoff=0.5))],
    ids=["microbatches_without_stages", "microbatches_not_dividing",
         "negative_retries", "negative_backoff", "backoff_without_retries"])
def test_fleet_spec_errors_name_the_jax_field(make):
    import repro_torch.pipeline as tpipe
    with pytest.raises(SpecError) as got:
        make(tpipe)
    with pytest.raises(jpipe.SpecError) as want:
        make(jpipe)
    assert got.value.field == want.value.field


@pytest.mark.parametrize("placement", [(1, 1), (2, 1), (1, 2), (2, 2)],
                         ids=["single", "dp", "pp", "hybrid"])
def test_spec_mode_equals_jax(placement):
    R, S = placement
    got = ExecutionSpec(placement=Placement(replicas=R, pp_stages=S))
    want = jpipe.ExecutionSpec(placement=jpipe.Placement(replicas=R,
                                                         pp_stages=S))
    assert got.mode == want.mode


@pytest.mark.parametrize("flags", [
    ["--replicas", "2", "--fail-at", "0.01", "--recover-at", "0.03",
     "--retries", "2", "--backoff", "0.001", "--clock", "modeled"],
    ["--pp-stages", "2", "--microbatches", "2", "--slo", "0.05",
     "--straggler-every", "4", "--straggler-cost", "3"],
    ["--replicas", "2", "--pp-stages", "2", "--mtbf", "0.02", "--mttr",
     "0.01", "--retries", "3", "--clock", "modeled", "--max-queue", "6"]],
    ids=["dp_faults", "pp", "hybrid_mtbf"])
def test_fleet_cli_on_cpu(tmp_path, capsys, flags):
    out_json = tmp_path / "report.json"
    main(["--smoke", "--device", "cpu", "--requests", "21",
          "--report-json", str(out_json)] + flags)
    out = capsys.readouterr().out
    rep = json.loads(out_json.read_text())
    assert rep["n_done"] + rep["n_failed"] + rep["n_rejected"] == 21
    mode = {"dp_faults": "dp", "pp": "pp", "hybrid_mtbf": "hybrid"}
    assert f"mode {rep['mode']}" in out and rep["mode"] in mode.values()
    if "--fail-at" in flags:
        assert rep["n_failures"] == 1 and "chaos:" in out
    if "--pp-stages" in flags:
        assert "pipeline stages" in out and rep["bubble_fraction"] > 0
