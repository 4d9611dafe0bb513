"""The port's dry run (slice 8c) against the JAX package's.

JAX's dry run lowers a cell to XLA on forced host devices; the port traces
it on fake tensors over a ``fake`` process group. Both need a process of
their own (JAX fixes its device count when it starts, a process holds one
default group), so each side runs in one subprocess and the tests compare
what they print: the smoke cell's argument bytes a device (exact, equal to
XLA's ``memory_analysis``), the work each rank's attention core and SSM
scans do (the batch x heads they run, equal to the batch extent of XLA's
batched dot), ``model_flops_for`` of every cell (equal), the collective
counter on a product DTensor must gather, and the CLIs.
``repro.launch.dryrun`` is imported only in the subprocess: it forces 512
devices when imported.
"""
import ast
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core import roofline as jroof
from repro.core.config import applicable_shapes as jax_applicable_shapes
from repro_torch.configs import get_config
from repro_torch.core import roofline as troof
from repro_torch.core.config import get_shape
from repro_torch.launch import dryrun, hillclimb

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
KINDS = ("train", "prefill", "decode")


def _run(code: str, *args, timeout=600) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          *args], env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


# the cells whose cores are held against JAX's: (arch, mesh), each train
# and prefill at batch 8 x 32. xlstm also on (2, 2), where GSPMD cuts the
# mLSTM's heads as the port does (on (2, 4) it computes each on two ranks)
CORE_CELLS = (("qwen3_8b", (2, 4)), ("zamba2_1p2b", (2, 4)),
              ("xlstm_125m", (2, 4)), ("xlstm_125m", (2, 2)))
CORE_KINDS = ("train", "prefill")
# each core's forward product in JAX's HLO (its einsum, in the dot's
# op_name) and the port's function that runs it on a rank's shard
CORES = {"attention": ("bqhgd,bkhd->bhgqk", "attention", ("_naive",
                                                         "_chunked")),
         "ssd": ("bqjh,bjhp->bqhp", "ssm", ("_ssd_scan",)),
         "mlstm": ("bihp,bjhp->bijh", "ssm", ("_mlstm_scan",))}


def _cell_key(arch, mesh, kind):
    return f"{arch}/{mesh[0]}x{mesh[1]}/{kind}"


@functools.lru_cache(maxsize=None)
def _jax_side() -> dict:
    """JAX on 8 forced devices: the qwen3-8b smoke cell of each kind on a
    (2, 4) mesh (``memory_analysis`` and the HLO collectives), each core's
    batch extent in the ``CORE_CELLS`` (read from the HLO right after
    XLA's SPMD partitioner, where each dot has its local shape and still
    its einsum's name), and ``model_flops_for`` of every full-size
    cell."""
    return _run(f"""
        import math, os, re, shutil, tempfile
        dump = tempfile.mkdtemp()
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count=8 --xla_dump_to=" + dump
            + " --xla_dump_hlo_pass_re=spmd-partitioning")
        import json, jax
        jax.devices()              # 8 devices, before dryrun asks for 512
        from repro.configs import ARCH_IDS, get_config
        from repro.core import roofline as R
        from repro.core.config import ShapeSpec, applicable_shapes
        from repro.launch import dryrun as D
        from repro.launch.mesh import compat_make_mesh, rules_for_mesh
        from repro.parallel.sharding import DEFAULT_RULES, sharding_ctx
        DOT = re.compile(r"= \\w+\\[([\\d,]*)\\]\\S* dot\\(.*?"
                         r"lhs_batch_dims=\\{{([\\d,]*)\\}}.*?"
                         r'op_name="([^"]*)"')
        CORES = {{k: v[0] for k, v in {CORES!r}.items()}}

        def compile_cell(cfg, mesh, kind):
            rules = dict(DEFAULT_RULES, **rules_for_mesh(mesh))
            shape = ShapeSpec("smoke", 32, 8, kind)
            seen = set(os.listdir(dump))
            with sharding_ctx(mesh, rules):
                fn, args, donate = D.build_cell(cfg, shape, mesh, rules)
                with mesh:
                    c = jax.jit(fn, donate_argnums=donate).lower(
                        *args).compile()
            new, = [f for f in set(os.listdir(dump)) - seen
                    if f.endswith(".txt") and ".after_spmd-partitioning." in f]
            cores = {{}}
            with open(os.path.join(dump, new)) as f:
                for line in f:
                    m = DOT.search(line)
                    if not m or "transpose(" in m.group(3):  # forward only
                        continue
                    for core, einsum in CORES.items():
                        if einsum + "/" in m.group(3):
                            dims = [int(d) for d in m.group(1).split(",")]
                            n = len(m.group(2).split(","))
                            cores.setdefault(core, set()).add(
                                math.prod(dims[:n]))
            return c, {{k: sorted(v) for k, v in cores.items()}}

        out = {{"smoke": {{}}, "cores": {{}}, "flops": {{}}}}
        cfg = get_config("qwen3_8b").smoke()
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        for kind in {KINDS!r}:
            c, cores = compile_cell(cfg, mesh, kind)
            out["smoke"][kind] = {{
                "args": int(c.memory_analysis().argument_size_in_bytes),
                "coll": R.collective_bytes_from_hlo(c.as_text())}}
            if kind in {CORE_KINDS!r}:
                out["cores"]["qwen3_8b/2x4/" + kind] = cores
        for arch, shape in {CORE_CELLS!r}:
            if arch == "qwen3_8b":
                continue
            mesh = compat_make_mesh(shape, ("data", "model"))
            for kind in {CORE_KINDS!r}:
                key = f"{{arch}}/{{shape[0]}}x{{shape[1]}}/{{kind}}"
                out["cores"][key] = compile_cell(
                    get_config(arch).smoke(), mesh, kind)[1]
        shutil.rmtree(dump)
        for a in ARCH_IDS:
            for s in applicable_shapes(get_config(a)):
                out["flops"][a + "/" + s.name] = D.model_flops_for(
                    get_config(a), s)
        print(json.dumps(out))
    """)


@functools.lru_cache(maxsize=None)
def _port_side() -> dict:
    """The port on a fake (2, 4) mesh: the same smoke cells traced (and
    the ``CORE_CELLS``, each core's function wrapped to record the batch x
    heads of rank 0's shard), and a ``Shard(0)`` x ``Shard(1)`` product on
    a fake 1-D mesh of 4."""
    return _run(f"""
        import json, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed import tensor as dt
        from torch.distributed.tensor import Shard
        from repro_torch.configs import get_config
        from repro_torch.core.config import ShapeSpec
        from repro_torch.core.roofline import TraceCounter
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_mesh, smoke_mesh, teardown
        from repro_torch.models import attention, ssm
        out = {{"smoke": {{}}, "cores": {{}}}}
        seen = {{}}

        def record(core, fn):      # a (B, S, heads..., width) first input
            def run(x, *a, **k):
                seen.setdefault(core, set()).add(
                    x.numel() // (x.shape[1] * x.shape[-1]))
                return fn(x, *a, **k)
            return run
        for core, (_, mod, names) in {CORES!r}.items():
            mod = attention if mod == "attention" else ssm
            for name in names:
                setattr(mod, name, record(core, getattr(mod, name)))

        def cores():
            got = {{k: sorted(v) for k, v in seen.items()}}
            seen.clear()
            return got

        cfg = get_config("qwen3_8b").smoke()
        mesh = make_mesh((2, 4), ("data", "model"))
        for kind in {KINDS!r}:
            shape = ShapeSpec("smoke", 32, 8, kind)
            c, arg_bytes = D.trace_cell(cfg, shape, mesh,
                                        D.cell_rules(mesh, shape))
            out["smoke"][kind] = {{"args": arg_bytes, "coll": c.coll,
                                  "ops": c.ops, "peak": c.peak}}
            out["cores"]["qwen3_8b/2x4/" + kind] = cores()
        for arch, shp in {CORE_CELLS!r}:
            if arch == "qwen3_8b":
                continue
            if tuple(mesh.shape) != tuple(shp):
                teardown()
                mesh = make_mesh(shp, ("data", "model"))
            for kind in {CORE_KINDS!r}:
                shape = ShapeSpec("smoke", 32, 8, kind)
                D.trace_cell(get_config(arch).smoke(), shape, mesh,
                             D.cell_rules(mesh, shape))
                out["cores"][f"{{arch}}/{{shp[0]}}x{{shp[1]}}/{{kind}}"] = \
                    cores()
        teardown()
        mesh = make_mesh((4,), ("model",))
        with FakeTensorMode():
            x = dt.empty((64, 32), device_mesh=mesh, placements=[Shard(0)])
            w = dt.empty((32, 80), device_mesh=mesh, placements=[Shard(1)])
            c = TraceCounter()
            with D._dtensor_internals(c), c:
                y = x @ w
        out["product"] = {{"coll": c.coll, "count": c.coll_count,
                          "ops": c.ops, "placements": str(y.placements),
                          "local": list(y.to_local().shape)}}
        teardown()
        m = smoke_mesh(2)
        out["smoke_mesh"] = [list(m.mesh_dim_names), list(m.shape)]
        print(json.dumps(out))
    """)


CORE_IDS = [_cell_key(a, m, k) for a, m in CORE_CELLS for k in CORE_KINDS]


@pytest.mark.parametrize("cell", CORE_IDS)
def test_cores_cut_over_model_as_jax_cuts_them(cell):
    """On rank 0 of the port's trace each attention core and SSM scan
    runs the batch x heads that XLA's batched dot of the same core runs
    on a device (its batch dims: the batch, and the query heads or SSM
    heads): the query heads cut over "model" as JAX's query is, the SSD
    and mLSTM heads as GSPMD carries the projections' cut into the scans,
    one query head a rank here (so JAX's batch dims hold no group
    dim). One exception, the mLSTM on (2, 4): GSPMD computes each of its
    4 heads on two of the 4 model ranks (2 heads a rank, as the gate
    projection's (2, heads) view carries its cut), where the port's
    "heads" rule gives each rank its own head: half JAX's work."""
    port = _port_side()["cores"][cell]
    jax_ = _jax_side()["cores"][cell]
    assert set(port) == set(jax_) and port, (port, jax_)
    print(f"\n[cores] {cell}: port {port}; JAX {jax_}")
    for core in port:
        if cell.startswith("xlstm_125m/2x4/") and core == "mlstm":
            # batch 4 a rank x 1 head, against JAX's 4 x 2
            assert port[core] == [4] and jax_[core] == [8]
        else:
            assert port[core] == jax_[core], core


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_argument_bytes_equal_jax_memory_analysis(kind):
    """qwen3-8b ``smoke()`` on a (2, 4) mesh: the state or parameters and
    the batch (the decode cache too) a device, exactly XLA's argument
    size."""
    assert _port_side()["smoke"][kind]["args"] == \
        _jax_side()["smoke"][kind]["args"]


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_trace_counts_products_and_collectives(kind):
    got = _port_side()["smoke"][kind]
    assert set(got["ops"]) == {"float32"} and got["ops"]["float32"] > 0
    assert got["peak"] >= got["args"] > 0
    assert set(got["coll"]) >= set(troof.KINDS)
    assert got["coll"]["all-gather"] > 0        # the FSDP weight gathers


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_collectives_beside_jax(kind):
    """Not a gate (PERF.md section 7): the collective bytes a device the
    port's trace counts beside those JAX's ``collective_bytes_from_hlo``
    reads in XLA's HLO of the same cell; both move some bytes for every
    kind of step. ``pytest -s`` prints them."""
    port = _port_side()["smoke"][kind]["coll"]
    jax_ = _jax_side()["smoke"][kind]["coll"]
    print(f"\n[collectives] qwen3-8b smoke {kind} (2, 4): port {port}; "
          f"JAX {jax_}")
    assert sum(port.values()) > 0 and sum(jax_.values()) > 0


def test_collective_counter_records_the_gather():
    """x (64, 32) cut by rows and w (32, 80) by columns over 4 ranks: the
    product gathers x, one all-gather of its (16, 32) fp32 shard (2048
    bytes), and rank 0 multiplies (64, 32) by (32, 20)."""
    got = _port_side()["product"]
    assert got["coll"]["all-gather"] == 16 * 32 * 4
    assert got["count"] == dict(dict.fromkeys(troof.KINDS, 0),
                                **{"all-gather": 1})
    assert got["ops"] == {"float32": 2 * 64 * 32 * 20}
    assert got["local"] == [64, 20] and "Shard(dim=1)" in got["placements"]


def test_mesh_helpers_build_fake_meshes():
    """``smoke_mesh(2)``: JAX's (n, 1) ("data", "model") test mesh, over a
    fresh fake group after ``teardown`` freed the last one."""
    assert _port_side()["smoke_mesh"] == [["data", "model"], [2, 1]]


CELLS = [(a, s.name) for a in ARCH_IDS
         for s in jax_applicable_shapes(jax_get_config(a))]


@pytest.mark.parametrize("arch,shape_name", CELLS,
                         ids=["/".join(c) for c in CELLS])
def test_model_flops_equal_jax(arch, shape_name):
    assert dryrun.model_flops_for(get_config(arch), get_shape(shape_name)) \
        == _jax_side()["flops"][f"{arch}/{shape_name}"]


def test_roofline_report_is_jax_report_with_the_card_rates():
    kw = dict(arch="a", shape="s", mesh="m", chips=256,
              flops_per_device=3e14, bytes_per_device=2e11,
              collective_bytes_per_device=9e10,
              coll_breakdown={"all-gather": 9e10}, peak_memory_per_device=1.0,
              model_flops=5e16)
    t, j = troof.RooflineReport(**kw), jroof.RooflineReport(**kw)
    assert set(t.to_dict()) == set(j.to_dict())
    peak = troof.H100.peak_ops("bfloat16")
    assert t.t_compute == 3e14 / peak
    assert t.t_memory == 2e11 / troof.H100.hbm_bw
    assert t.t_collective == 9e10 / troof.NVLINK_BW == 0.2
    assert t.bottleneck == "compute" and t.t_bound == t.t_compute
    assert t.useful_flops_ratio == 5e16 / (3e14 * 256)
    assert t.roofline_fraction == pytest.approx(
        5e16 / (256 * peak) / t.t_compute)


def test_analyze_trace_reads_the_counter():
    c = troof.TraceCounter()
    c.ops = {"bfloat16": 10, "float32": 5}
    c.bytes, c.peak = 7, 11
    c.coll = dict(dict.fromkeys(troof.KINDS, 0), **{"all-reduce": 3})
    rep = troof.analyze_trace(c, arch="a", shape="s", mesh_name="m",
                              chips=8, model_flops=1.0)
    assert (rep.flops_per_device, rep.bytes_per_device,
            rep.collective_bytes_per_device, rep.peak_memory_per_device) == \
        (15.0, 7.0, 3.0, 11.0)
    assert rep.coll_breakdown["all-reduce"] == 3


def test_hillclimb_plans_are_jax_plans():
    tree = ast.parse((SRC / "repro" / "launch" / "hillclimb.py").read_text())
    plans = next(ast.literal_eval(n.value) for n in tree.body
                 if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "PLANS")
    assert hillclimb.PLANS == plans


def _cli(*argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_dryrun_cli_writes_the_cell_and_fails_an_unknown_arch():
    out = dryrun.OUT_DIR / "pytest__xlstm_125m__decode_32k__pod16x16.json"
    out.unlink(missing_ok=True)
    try:
        res = _cli("repro_torch.launch.dryrun", "--arch", "xlstm_125m",
                   "--shape", "decode_32k", "--tag", "pytest")
        assert res.returncode == 0, res.stderr[-3000:]
        assert "all dry-run cells green" in res.stdout
        got = json.loads(out.read_text())
        assert got["mesh"] == "pod16x16" and got["chips"] == 256
        assert got["peak_bytes_per_device"] >= \
            got["argument_bytes_per_device"] > 0
        assert got["bottleneck"] in ("compute", "memory", "collective")
    finally:
        out.unlink(missing_ok=True)
    res = _cli("repro_torch.launch.dryrun", "--arch", "nope", "--shape",
               "train_4k", "--tag", "pytest")
    assert res.returncode == 1 and "[dryrun] FAIL nope" in res.stdout
