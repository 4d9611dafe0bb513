"""The port's DSE against the JAX package's, on the CPU.

Plan tables (``pipeline/plan_table.py``): the committed format 1/2/3
fixtures load in both packages and re-serialise byte for byte alike;
``plan_key`` gives JAX's string; a port table round-trips byte-stable; a
JAX table seeds nothing. Compiles (``pipeline/compile.py``): a repeat or
``plan_path=`` compile runs no sweep, a seeded ``measure=True`` compile
inherits the seed's measurements, ``roofline_breakdown`` has a row a
group, and each group's plan reaches its kernel wrapper. The stage
planner, the roofline and the profiler's ``trimmed_mean`` equal JAX's
(exactly: same arithmetic on the same floats). The modelled clock gives
the JAX engine's completions for the same round time (``t_done`` to
1e-12 s). ``matmul_pipe``/``ops.fc`` with the bias omitted (F1) equal
JAX's: fp32 to rtol = atol = 1e-4, bf16 to one bf16 ulp, int8 bit for
bit. The reference's Pallas conv raises under this jax (``pl.Unblocked``),
so no test here runs it: tables, engines and planners run no kernel.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.configs import get_config as jax_get_config
from repro.core import roofline as jroof
from repro.kernels import ops as jops
from repro.kernels.matmul_pipe import matmul_pipe as jax_matmul_pipe
from repro.launch.serve_cnn import synthetic_requests as jax_requests
from repro.models.cnn import init_cnn_params as jax_init_cnn_params
from repro.obs import profiler as jprofiler
from repro.pipeline import plan_table as jplan_table
from repro.serve import stage_planner as jsp
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.core import roofline
from repro_torch.core.config import SpecError
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.conv_pipe import conv_pipe, conv_tile, pool_tile
from repro_torch.kernels.matmul_pipe import fc_split, matmul_pipe
from repro_torch.launch.serve_cnn import synthetic_requests
from repro_torch.models.cnn import cnn_forward_stage, cnn_forward_stage_quant
from repro_torch.models.cnn import params_from_jax
from repro_torch.obs import profiler
from repro_torch.pipeline import (ExecutionSpec, PlanTable, Precision,
                                  Serving, Tiling, compile_cnn, load_plan,
                                  plan_key)
from repro_torch.pipeline.compile import _group_shapes
from repro_torch.serve import stage_planner as sp

FIXTURES = Path(__file__).resolve().parent / "fixtures"
FORMATS = [FIXTURES / f"plan_table_format{n}.json" for n in (1, 2, 3)]
TAG = roofline.H100.tag
FP32 = dict(rtol=1e-4, atol=1e-4)        # tests/test_kernels.py fp32


@pytest.fixture(autouse=True)
def fresh_registry():
    autotune.clear_registry()
    autotune.reset_sweep_stats()
    autotune.reset_measure_stats()
    profiler.clear_measure_cache()
    yield
    autotune.clear_registry()


def _smoke(arch="alexnet"):
    return get_config(arch).smoke()


# -- plan tables ----------------------------------------------------------

@pytest.mark.parametrize("path", FORMATS, ids=lambda p: p.stem)
def test_fixture_tables_serialise_as_jax(path):
    text = path.read_text()
    port, jax_tbl = PlanTable.from_json(text), \
        jplan_table.PlanTable.from_json(text)
    assert port.to_json() == jax_tbl.to_json()
    assert load_plan(str(path)).to_json() == port.to_json()
    assert port.summary() == jax_tbl.summary()
    assert port.measurements() == jax_tbl.measurements()


@pytest.mark.parametrize("path", FORMATS, ids=lambda p: p.stem)
def test_plan_key_is_jax_string(path):
    tbl = PlanTable.from_json(path.read_text())
    for row in tbl.conv + tbl.gemm:
        assert plan_key(row) == jplan_table.plan_key(row)
        assert "tpu" == row["backend"]


@pytest.mark.parametrize("path", FORMATS, ids=lambda p: p.stem)
def test_jax_table_seeds_nothing(path):
    tbl = PlanTable.from_json(path.read_text())
    assert len(tbl) > 0 and tbl.seed() == 0
    assert autotune.registry_snapshot() == []
    assert autotune.gemm_registry_snapshot() == []


def test_port_table_round_trips_byte_stable(tmp_path):
    c = compile_cnn(_smoke(), device="cpu")
    text = c.plans().to_json()
    again = PlanTable.from_json(text)
    assert again.to_json() == text and again == c.plans()
    path = c.save_plan(str(tmp_path / "plans.json"))
    assert Path(path).read_text() == text
    assert {r["backend"] for r in again.conv + again.gemm} == {TAG}
    # the JAX package reads the port's document too, byte for byte alike
    assert jplan_table.PlanTable.from_json(text).to_json() == text


# -- compiles ------------------------------------------------------------

def test_second_compile_sweeps_nothing():
    cfg = _smoke()
    compile_cnn(cfg, device="cpu")
    first = autotune.sweep_stats()
    assert first["conv_sweeps"] == 5 and first["gemm_sweeps"] == 3
    c = compile_cnn(cfg, device="cpu")
    after = autotune.sweep_stats()
    assert after["conv_sweeps"] == first["conv_sweeps"]
    assert after["gemm_sweeps"] == first["gemm_sweeps"]
    assert c.plans().provenance["sweep_stats"]["conv_sweeps"] == 0


@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_plan_path_compile_sweeps_nothing(tmp_path, arch):
    cfg = _smoke(arch)
    a = compile_cnn(cfg, device="cpu")
    path = a.save_plan(str(tmp_path / "p.json"))
    autotune.clear_registry()
    autotune.reset_sweep_stats()
    b = compile_cnn(cfg, device="cpu", plan_path=path)
    stats = autotune.sweep_stats()
    assert stats["conv_sweeps"] == 0 and stats["gemm_sweeps"] == 0
    assert b.plans().to_json() == Path(path).read_text()
    assert b.group_plans == a.group_plans


def _fake_timer(monkeypatch):
    """Stand-ins for the card's stopwatch: the measure functions return
    a fixed time per plan and count as the real ones do."""
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


def test_measured_compile_then_seeded_compile_inherits(monkeypatch,
                                                       tmp_path):
    _fake_timer(monkeypatch)
    cfg = _smoke()
    m = compile_cnn(cfg, device="cpu", measure=True)
    tbl = m.plans()
    assert tbl.summary() == {"conv_plans": 5, "gemm_plans": 3,
                             "measured_plans": 8}
    prov = tbl.provenance["measurement"]
    assert prov["measure_stats"]["conv_measured"] == 5 * 5   # 5 repeats
    assert prov["backend"]["timer"] == "cuda events"
    for row in tbl.conv + tbl.gemm:
        assert row["measured"]["t_measured"] > 0
        assert "interpret" not in row["measured"]
    path = m.save_plan(str(tmp_path / "measured.json"))
    autotune.clear_registry()
    before = autotune.measure_stats()
    s = compile_cnn(cfg, device="cpu", plan_path=path, measure=True)
    assert autotune.measure_stats() == before
    assert s.plans().to_json() == Path(path).read_text()
    assert s.plans().measurements() == tbl.measurements()
    rows = s.roofline_breakdown()
    assert all(r["t_measured"] is not None and r["drift"] ==
               pytest.approx(r["t_measured"] / r["t_model"]) for r in rows)


def test_measure_cache_makes_a_warm_recompile_time_nothing(monkeypatch):
    _fake_timer(monkeypatch)
    cfg = _smoke()
    compile_cnn(cfg, device="cpu", measure=True)
    n = autotune.measure_stats()
    c = compile_cnn(cfg, device="cpu", measure=True)
    after = autotune.measure_stats()
    assert after["conv_measured"] == n["conv_measured"]
    assert after["conv_measure_hits"] == n["conv_measure_hits"] + 5
    assert c.plans().provenance["measurement"]["measure_stats"][
        "gemm_measure_hits"] == 3


def test_measuring_without_a_card_raises():
    shape = autotune.ConvShape(h=8, w=8, c=8, kh=3, kw=3, m=8, pad=1, b=2)
    plan = autotune.best_plan(shape)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune.measure_plan(shape, plan, device="cpu")


@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_roofline_breakdown_row_a_group(arch, quant):
    spec = ExecutionSpec(precision=Precision(quant="int8" if quant
                                             else "none"))
    c = compile_cnn(_smoke(arch), spec, device="cpu")
    rows = c.roofline_breakdown()
    jcfg = jax_get_config(arch).smoke()
    jgroups = [g for g, _, _ in jpipe.compile._group_shapes(
        jcfg, 8, "int8" if quant else "float32")]
    assert [tuple(r["group"]) for r in rows] == jgroups
    assert set(c.group_plans) == set(jgroups)
    for r in rows:
        assert r["t_model"] == max(r["t_compute"], r["t_memory"])
        assert r["bound"] == ("compute" if r["t_compute"] >= r["t_memory"]
                              else "memory")
        assert r["t_measured"] is None and r["drift"] is None


def _spy(monkeypatch):
    """Record the plan keyword of every kernel-wrapper call the fold
    makes (the tile of a conv, the split of an FC)."""
    seen = []

    def conv(*a, tile=None, **kw):
        seen.append(("conv", tile))
        return conv_pipe(*a, tile=tile, **kw)

    def fc(*a, split=None, **kw):
        seen.append(("gemm", split))
        return matmul_pipe(*a, split=split, **kw)
    monkeypatch.setattr(ops, "conv_pipe", conv)
    monkeypatch.setattr(ops, "matmul_pipe", fc)
    return seen


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
def test_each_group_plan_reaches_its_kernel(monkeypatch, mode, arch):
    cfg = _smoke(arch)
    spec = ExecutionSpec(precision=Precision(
        dtype="bfloat16" if mode == "bf16" else "float32",
        quant="int8" if mode == "int8" else "none"))
    c = compile_cnn(cfg, spec, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, cfg.input_hw, cfg.input_hw, 3)).astype(np.float32))
    seen = _spy(monkeypatch)
    got = c.forward(x)
    want = [("conv", p.tile) if isinstance(p, autotune.ConvPlan)
            else ("gemm", p.split)
            for g, p in sorted(c.group_plans.items())]
    assert seen == want
    # the default plans are the rules' tiles: the fold without plans
    # (each wrapper's own rule) gives the same logits
    seen.clear()
    xin = x.to(c.model.in_dtype)
    with torch.inference_mode():
        plain = (cnn_forward_stage_quant(c.params, xin, cfg, c.model.groups)
                 if mode == "int8" else
                 cnn_forward_stage(c.params, xin, cfg, c.model.groups))
    assert all(p is None for _, p in seen)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_default_plans_are_the_rules_tiles(mode):
    """At full width, VGG-16 batch 8: every group's plan is the tile or
    split the kernel's rule picks on an H100 (132 SMs)."""
    cfg = get_config("vgg16")
    dt = getattr(torch, mode)
    for g, kind, shape in _group_shapes(cfg, 8, mode):
        if kind == "conv":
            plan = autotune.get_plan(shape, backend=TAG)
            assert plan.tile == conv_tile(
                dt, 8, shape.oh, shape.ow, shape.m // shape.groups,
                shape.groups, shape.pool, shape.pool_k, shape.pool_s, 132,
                shape.c // shape.groups)
        else:
            plan = autotune.get_gemm_plan(shape, backend=TAG)
            assert plan.split == fc_split(dt, shape.m, shape.k, shape.n, 132)
        t_ops, t_bytes = (autotune.conv_bound(shape) if kind == "conv"
                          else autotune.gemm_bound(shape))
        per_call = plan.t_model * (shape.b if kind == "conv" else 1)
        assert per_call >= max(t_ops, t_bytes) * (1 - 1e-12)


def test_pinned_plans_reach_the_kernels_and_bad_ones_raise(monkeypatch):
    cfg = _smoke("vgg16")
    base = compile_cnn(cfg, device="cpu")
    other = {}
    shapes = list(_group_shapes(cfg, 8, "float32"))
    for g, kind, shape in shapes:
        cands = (autotune.enumerate_plans(shape) if kind == "conv"
                 else autotune.enumerate_gemm_plans(shape))
        other[g] = next(p for p in cands if p != base.group_plans[g])
    conv_rows, gemm_rows = [], []
    for g, kind, shape in shapes:
        (conv_rows if kind == "conv" else gemm_rows).append(
            {"shape": dataclasses.asdict(shape), "backend": TAG,
             "vmem_budget": Tiling().vmem_budget,
             "plan": other[g].to_dict()})
    pinned = PlanTable.from_rows(conv_rows, gemm_rows)
    autotune.clear_registry()
    c = compile_cnn(cfg, device="cpu", plans=pinned)
    assert c.group_plans == other
    x = torch.randn(8, cfg.input_hw, cfg.input_hw, 3)
    want = base.forward(x)
    seen = _spy(monkeypatch)
    torch.testing.assert_close(c.forward(x), want, **FP32)
    assert [p for _, p in seen] == [
        p.tile if isinstance(p, autotune.ConvPlan) else p.split
        for _, p in sorted(other.items())]
    # a pooled layer's patch over the tile's rows, an uninstantiated tile
    # or split: the wrappers raise on every device
    xp = torch.randn(1, 16, 16, 4)
    w = torch.randn(3, 3, 4, 8)
    conv_pipe(xp, w, torch.zeros(8), pad=1, pool="max", tile=(64, 64, 4, 4))
    with pytest.raises(ValueError, match="over the tile's 64 rows"):
        conv_pipe(xp, w, torch.zeros(8), pad=1, pool="max",
                  tile=(64, 64, 5, 5))
    with pytest.raises(ValueError, match="no torch.float32 kernel"):
        conv_pipe(xp, w, torch.zeros(8), pad=1, tile=(96, 64, 1, 1))
    with pytest.raises(ValueError, match="ranks"):
        matmul_pipe(torch.randn(2, 64), torch.randn(64, 8), split=(64, 8))
    # and a table whose plan does not fit its layer fails the compile
    bad = PlanTable.from_rows([dict(conv_rows[1], plan=dict(
        conv_rows[1]["plan"], tph=50, tpw=50))], gemm_rows)
    autotune.clear_registry()
    with pytest.raises(ValueError, match="does not fit"):
        compile_cnn(cfg, device="cpu", plans=bad)


# -- the stage planner ----------------------------------------------------

@pytest.mark.parametrize("arch", ["alexnet", "vgg16"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_group_io_shapes_equal_jax(arch, smoke):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if smoke:
        cfg, jcfg = cfg.smoke(), jcfg.smoke()
    assert sp.group_io_shapes(cfg) == jsp.group_io_shapes(jcfg)


@pytest.mark.parametrize("k", range(1, 9))
def test_min_max_partition_equals_jax(k):
    costs = list(np.random.default_rng(k).random(16) * 1e-3)
    assert sp._min_max_partition(costs, k) == jsp._min_max_partition(
        costs, k)


@pytest.mark.parametrize("n_stages", [1, 2, 3, 5])
def test_plan_stages_partition_equals_jax(monkeypatch, n_stages):
    cfg, jcfg = get_config("vgg16"), jax_get_config("vgg16")
    groups = [g for g, _, _ in sp.group_io_shapes(cfg)]
    cost = dict(zip(groups, np.random.default_rng(n_stages).random(
        len(groups)).tolist()))
    monkeypatch.setattr(sp, "group_cost",
                        lambda cfg, g, i, o, batch, **kw: cost[g])
    monkeypatch.setattr(jsp, "group_cost",
                        lambda cfg, g, i, o, batch, **kw: cost[g])
    got = sp.plan_stages(cfg, n_stages, batch=4)
    want = jsp.plan_stages(jcfg, n_stages, batch=4)
    assert [s.groups for s in got.stages] == [s.groups for s in want.stages]
    assert [s.t_model for s in got.stages] == [s.t_model
                                               for s in want.stages]
    assert got.round_time(3) == want.round_time(3)
    assert got.bubble(3) == want.bubble(3)
    assert got.max_boundary_elems() == want.max_boundary_elems()


def test_total_cost_is_the_sum_of_group_costs():
    cfg = get_config("alexnet")
    costs = [sp.group_cost(cfg, g, i, o, 8)
             for g, i, o in sp.group_io_shapes(cfg)]
    assert sp.total_cost(cfg, 8) == pytest.approx(sum(costs), rel=1e-15)
    assert all(c > 0 for c in costs)
    plan = sp.plan_stages(cfg, 3, batch=8)
    assert plan.t_sum == pytest.approx(sum(costs), rel=1e-12)


# -- the roofline ---------------------------------------------------------

TPU = roofline.DeviceProfile(
    name="TPU v5e", sms=1, clock_mhz=1.0, hbm_bw=jroof.HBM_BW,
    smem_per_block=jroof.VMEM_BYTES, ffma_per_clock_sm=jroof.PEAK_FLOPS / 2e6,
    bf16_per_clock_sm=jroof.PEAK_FLOPS / 1e6,
    int8_per_clock_sm=jroof.PEAK_OPS_INT8 / 1e6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("util", [1.0, 0.25, 0.0])
def test_time_bounds_equal_jax(dtype, util):
    for flops, nbytes in ((3.7e12, 1.1e9), (12345.0, 678.0), (0.0, 0.0)):
        assert roofline.time_bounds(flops, nbytes, mxu_util=util,
                                    dtype=dtype, profile=TPU) == \
            jroof.time_bounds(flops, nbytes, mxu_util=util, dtype=dtype)


@pytest.mark.parametrize("s,m", [(1, 1), (2, 4), (4, 8), (8, 1), (3, 7)])
def test_bubble_fraction_and_trimmed_mean_equal_jax(s, m):
    assert roofline.pipeline_bubble_fraction(s, m) == \
        jroof.pipeline_bubble_fraction(s, m)
    samples = list(np.random.default_rng(s * m).random(m + 2))
    assert profiler.trimmed_mean(samples, s % 3) == \
        jprofiler.trimmed_mean(samples, s % 3)


def test_h100_profile_rates():
    p = roofline.H100
    assert p.tag == "cuda:sm_90:132" and p.smem_per_block == 232448
    assert p.peak_ops("float32") == pytest.approx(66.9e12, rel=1e-3)
    assert p.peak_ops("bfloat16") == pytest.approx(1070.5e12, rel=1e-4)
    assert p.peak_ops("int8") == pytest.approx(2141e12, rel=1e-3)
    assert roofline.profile_for("cuda:sm_90:114").sms == 114
    assert roofline.device_profile("cpu") is p


@pytest.mark.parametrize("kind,shape,want_ms,by", [
    ("conv", dict(h=224, w=224, c=64, kh=3, kw=3, m=64, pad=1, pool="max",
                  dtype="float32"), 0.4423, "operations"),
    ("gemm", dict(m=8, k=25088, n=4096, dtype="float32"), 0.1230, "bytes"),
    ("gemm", dict(m=8, k=25088, n=4096, dtype="int8"), 0.0308, "bytes"),
    ("conv", dict(h=28, w=28, c=512, kh=3, kw=3, m=512, pad=1,
                  dtype="bfloat16"), 0.0276, "operations")],
    ids=["conv1_2_fp32", "fc6_fp32", "fc6_int8", "conv4_2_bf16"])
def test_bound_reproduces_perf_section_5(kind, shape, want_ms, by):
    """VGG-16 batch 8 on the H100 profile: the bounds PERF.md section 5
    lists (chip_smoke.py's, on the card)."""
    if kind == "conv":
        s = autotune.ConvShape(b=8, **shape)
        t_ops, t_bytes = autotune.conv_bound(s)
    else:
        s = autotune.GemmShape(**shape)
        t_ops, t_bytes = autotune.gemm_bound(s)
    # PERF.md prints four decimals: the bound rounds to them
    assert round(max(t_ops, t_bytes) * 1e3, 4) == want_ms
    assert ("operations" if t_ops >= t_bytes else "bytes") == by


# -- the modelled clock ---------------------------------------------------

@pytest.mark.parametrize("costs", [False, True], ids=["nominal", "straggler"])
def test_modelled_clock_completions_equal_jax(costs):
    cfg, jcfg = _smoke(), jax_get_config("alexnet").smoke()
    reqs = synthetic_requests(19, cfg.input_hw, cfg.input_ch, 2000.0)
    jreqs = jax_requests(19, jcfg.input_hw, jcfg.input_ch, 2000.0)
    if costs:
        for r, j in zip(reqs, jreqs):
            r.cost = j.cost = 1.0 + (r.rid % 4 == 3) * 2.5
    spec = ExecutionSpec(serving=Serving(batch=4, clock="modeled",
                                         execute=False, max_queue=6))
    c = compile_cnn(cfg, spec, device="cpu")
    rep = c.serve(reqs)
    t_round = c.engine.t_round_model
    assert t_round == pytest.approx(sp.total_cost(cfg, 4), rel=1e-15)
    jeng = JServeEngine(jcfg, jax_init_cnn_params(jax.random.key(0), jcfg),
                        batch=4, clock="modeled", execute=False, max_queue=6)
    jeng.t_round_model = t_round
    jeng._versions[0]["t_round"] = t_round
    jdone, jrep = jeng.serve(jreqs)
    assert [(d.rid, d.status, d.pred) for d in rep.completions] == \
        [(d.rid, d.status, d.pred) for d in jdone]
    np.testing.assert_allclose([d.t_done for d in rep.completions],
                               [d.t_done for d in jdone], rtol=0, atol=1e-12)
    assert rep.rounds == jrep.rounds and rep.n_rejected == jrep.n_rejected
    assert rep.p50_ms == pytest.approx(jrep.p50_ms, abs=1e-9)
    assert rep.p95_ms == pytest.approx(jrep.p95_ms, abs=1e-9)
    assert rep.clock == "modeled" and all(d.pred == -1
                                          for d in rep.completions)


def test_modelled_clock_executing_gives_the_forwards_preds():
    cfg = _smoke()
    jcfg = jax_get_config("alexnet").smoke()
    params = params_from_jax(jax_init_cnn_params(jax.random.key(3), jcfg),
                             "cpu")
    reqs = synthetic_requests(11, cfg.input_hw, cfg.input_ch, 200.0)
    c = compile_cnn(cfg, ExecutionSpec(serving=Serving(
        batch=4, clock="modeled")), params, device="cpu")
    rep = c.serve(reqs)
    imgs = np.stack([r.image for r in reqs])
    preds = torch.cat([c.forward(imgs[i:i + 4]).argmax(-1)
                       for i in range(0, 11, 4)]).tolist()
    assert [d.pred for d in sorted(rep.completions, key=lambda d: d.rid)] \
        == preds
    assert all(d.status == "ok" for d in rep.completions)
    assert rep.makespan_s == pytest.approx(
        max(d.t_done for d in rep.completions))


# -- the spec -------------------------------------------------------------

@pytest.mark.parametrize("name", [f.name for f in dataclasses.fields(
    jpipe.Tiling)])
def test_every_tiling_field_is_accepted_or_refused_by_name(name):
    value = {"autotune": False, "vmem_budget": 100_000, "vec_size": 16,
             "cu_num": 64, "oh_blk": 4, "b_blk": 2}[name]
    tiling = Tiling(**{name: value})
    if name in ("vec_size", "oh_blk", "b_blk", "cu_num"):
        with pytest.raises(SpecError) as e:
            ExecutionSpec(tiling=tiling)
        assert e.value.field == f"Tiling.{name}"
    else:
        ExecutionSpec(tiling=tiling)
    assert getattr(Tiling(), name) is not None


def test_cu_num_pins_tn_without_autotune(monkeypatch):
    cfg = _smoke("vgg16")
    spec = ExecutionSpec(tiling=Tiling(autotune=False, cu_num=128))
    c = compile_cnn(cfg, spec, device="cpu")
    convs = [p for p in c.group_plans.values()
             if isinstance(p, autotune.ConvPlan)]
    assert len(convs) == 13 and all(p.tn == 128 for p in convs)
    assert len(c.plans()) == 0            # no registry lookup, no row
    off = compile_cnn(cfg, ExecutionSpec(tiling=Tiling(autotune=False)),
                      device="cpu")
    assert off.group_plans == {} and len(off.plans()) == 0
    x = torch.randn(2, cfg.input_hw, cfg.input_hw, 3)
    torch.testing.assert_close(c.forward(x), off.forward(x), **FP32)


def test_small_budget_takes_the_models_best_fitting_plan():
    budget = 40_000
    c = compile_cnn(_smoke("vgg16"), ExecutionSpec(
        tiling=Tiling(vmem_budget=budget)), device="cpu")
    for row in c.plans().conv + c.plans().gemm:
        assert row["vmem_budget"] == budget
        assert row["plan"]["smem_bytes"] <= budget
    with pytest.raises(ValueError, match="no conv tile fits"):
        compile_cnn(_smoke(), ExecutionSpec(tiling=Tiling(vmem_budget=1000)),
                    device="cpu")


# -- F1: matmul_pipe and ops.fc with the bias omitted --------------------

def _ulps(got, want):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    return float((np.abs(g - w) / np.exp2(np.floor(np.log2(mag)) - 7)).max())


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fc_without_bias_equals_jax(dtype, relu):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((8, 300)) * 0.3).astype(np.float32)
    w = (rng.standard_normal((300, 70)) * 0.05).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    kernel = jax_matmul_pipe(xj, wj, relu=relu, interpret=True)
    via_ops = jops.fc(xj, wj, relu=relu, use_pallas=True)
    for got in (matmul_pipe(xt, wt, relu=relu), ops.fc(xt, wt, relu=relu),
                ops.fc(xt, wt, relu=relu, use_kernels=False)):
        assert got.dtype == tdt and tuple(got.shape) == kernel.shape
        for want in (kernel, via_ops):
            if dtype == "float32":
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           **FP32)
            else:
                assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("out_scale", [3.0 / 127, None], ids=["s8", "f32"])
def test_int8_matmul_without_bias_equals_jax(out_scale):
    rng = np.random.default_rng(8)
    x = rng.integers(-127, 128, (8, 256), dtype=np.int8)
    w = rng.integers(-127, 128, (256, 130), dtype=np.int8)
    scale = ((0.5 + rng.random(130)) / (127.0 ** 2 / 3 * 16)).astype(
        np.float32)
    want = np.asarray(jax_matmul_pipe(
        jnp.asarray(x), jnp.asarray(w), scale=jnp.asarray(scale),
        out_scale=out_scale, relu=True, interpret=True))
    got = matmul_pipe(torch.from_numpy(x), torch.from_numpy(w),
                      scale=torch.from_numpy(scale), out_scale=out_scale,
                      relu=True)
    assert got.dtype == (torch.int8 if out_scale else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    explicit = matmul_pipe(torch.from_numpy(x), torch.from_numpy(w),
                           torch.zeros(130), scale=torch.from_numpy(scale),
                           out_scale=out_scale, relu=True)
    assert torch.equal(got, explicit)


def test_pool_tile_rows_of_enumerated_plans_fit():
    shape = autotune.ConvShape(h=27, w=27, c=96, kh=5, kw=5, m=256, pad=2,
                               groups=2, pool="max", pool_k=3, pool_s=2,
                               b=8)
    plans = autotune.enumerate_plans(shape)
    assert {(p.tp, p.tn) for p in plans} == {(128, 128), (128, 64),
                                             (64, 128), (64, 64)}
    for p in plans:
        assert (p.tph, p.tpw) == pool_tile(shape.ph, shape.pw, 3, 2, p.tp)
        assert autotune.plan_fits(shape, p)
        assert not autotune.plan_fits(shape, p, p.smem_bytes - 1)
    assert json.loads(json.dumps(plans[0].to_dict())) == plans[0].to_dict()
