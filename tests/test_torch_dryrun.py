"""The port's dry run (slice 8c) against the JAX package's.

JAX's dry run lowers a cell to XLA on forced host devices; the port traces
it on fake tensors over a ``fake`` process group. Both need a process of
their own (JAX fixes its device count when it starts, a process holds one
default group), so each side runs in one subprocess and the tests compare
what they print: the smoke cell's argument bytes a device (exact, equal to
XLA's ``memory_analysis``), the work each rank's attention core and SSM
scans do (the batch x heads they run, equal to the batch extent of XLA's
batched dot), the products a device (equal to the HLO's dots), the
collective bytes a device (at most XLA's, every layer unrolled on both
sides), the embedding lookup's collectives, the sequence cut over
"model", the MoE's dispatch and
combine and the mLSTM's P cut against XLA's extents, ``model_flops_for``
of every cell (equal), the collective counter on a product DTensor must
gather, and the CLIs.
``repro.launch.dryrun`` is imported only in the subprocess: it forces 512
devices when imported.
"""
import ast
import functools
import json
import math
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
# the sequence cut over "model" (the hill climb's sequence-parallel
# iterations) on qwen3-8b's smoke cell; the MoE smoke cell (dbrx-132b,
# 4 experts on 4 model ranks); the mLSTM where GSPMD cuts each head's P
# (xlstm-125m's 4 heads on 16 model ranks, 4 ranks a head)
SEQ_RULES = {"seq": ("model",)}
MOE_CELL = ("dbrx_132b", (2, 4), "prefill")
P_CUT_CELL = ("xlstm_125m", (1, 16))
# the smoke cells whose products a device are held against the dots of
# XLA's HLO: the attention families (the SSM scans' einsums decompose into
# products of other shapes in XLA and in torch)
DOT_CELLS = (("qwen3_8b", (2, 4), ()), ("qwen3_8b", (2, 4), SEQ_RULES),
             ("dbrx_132b", (2, 4), ()))


def _cell_key(arch, mesh, kind, rules=()):
    return f"{arch}/{mesh[0]}x{mesh[1]}/{kind}" + ("/seq" if rules else "")


@functools.lru_cache(maxsize=None)
def _jax_side() -> dict:
    """JAX on 16 forced devices, every layer and chunk unrolled (XLA's HLO
    holds a scanned body once, whatever its trip count): the qwen3-8b
    smoke cell of each kind on a (2, 4) mesh (``memory_analysis`` and the
    HLO collectives), each core's batch extent in the ``CORE_CELLS`` (read
    from the HLO right after XLA's SPMD partitioner, where each dot has
    its local shape and still its einsum's name), the ``DOT_CELLS``'
    products a device (each dot's 2 x output x contraction), the
    sequence-cut cell's argument bytes and attention score block, the MoE
    cell's dispatch and combine extents and the collectives at them, the
    mLSTM's extent and P width at ``P_CUT_CELL``, and ``model_flops_for``
    of every full-size cell."""
    return _run(f"""
        import dataclasses, math, os, re, shutil, tempfile
        dump = tempfile.mkdtemp()
        os.environ["XLA_FLAGS"] = (
            "--xla_force_host_platform_device_count=16 --xla_dump_to="
            + dump + " --xla_dump_hlo_pass_re=spmd-partitioning")
        import json, jax
        jax.devices()              # 16 devices, before dryrun asks for 512
        from repro.configs import ARCH_IDS, get_config
        from repro.core import roofline as R
        from repro.core.config import ShapeSpec, applicable_shapes
        from repro.launch import dryrun as D
        from repro.launch.mesh import compat_make_mesh, rules_for_mesh
        from repro.parallel.sharding import DEFAULT_RULES, sharding_ctx
        INSTR = re.compile(r"^\\s*(?:ROOT\\s+)?(%[\\w.\\-]+) = \\(?\\w+"
                           r"\\[([\\d,]*)\\]\\S* ([\\w-]+)\\(([^)]*)\\)")
        CORES = {{k: v[0] for k, v in {CORES!r}.items()}}

        def dims(text):
            return [int(d) for d in text.split(",") if d]

        def compile_cell(cfg, mesh, kind, over=()):
            rules = dict(DEFAULT_RULES, **rules_for_mesh(mesh), **dict(over))
            shape = ShapeSpec("smoke", 32, 8, kind)
            cfg = dataclasses.replace(cfg, scan_layers=False)
            seen = set(os.listdir(dump))
            with sharding_ctx(mesh, rules):
                fn, args, donate = D.build_cell(cfg, shape, mesh, rules)
                with mesh:
                    c = jax.jit(fn, donate_argnums=donate).lower(
                        *args).compile()
            new, = [f for f in set(os.listdir(dump)) - seen
                    if f.endswith(".txt") and ".after_spmd-partitioning." in f]
            shapes, got = {{}}, {{"cores": {{}}, "score": [], "width": [],
                                 "dots": 0, "dispatch": [], "combine": [],
                                 "combine_ar": []}}
            with open(os.path.join(dump, new)) as f:
                lines = f.read().splitlines()
            for line in lines:
                m = INSTR.match(line)
                if m:
                    shapes[m.group(1)] = dims(m.group(2))
            for line in lines:
                m = INSTR.match(line)
                name = re.search(r'op_name="([^"]*)"', line)
                if not m or not name:
                    continue
                out, op, name = dims(m.group(2)), m.group(3), name.group(1)
                operands = re.findall(r"%[\\w.\\-]+", m.group(4))
                forward = "transpose(" not in name
                if op == "dot":
                    lhs = shapes[operands[0]]
                    lc, lb = (dims(a.group(1)) if a else [] for a in (
                        re.search(r"lhs_contracting_dims=\\{{([\\d,]*)\\}}",
                                  line),
                        re.search(r"lhs_batch_dims=\\{{([\\d,]*)\\}}",
                                  line)))
                    got["dots"] += 2 * math.prod(out) * math.prod(
                        lhs[d] for d in lc)
                    for core, einsum in CORES.items():
                        if forward and einsum in name:
                            got["cores"].setdefault(core, set()).add(
                                math.prod(out[:len(lb)]))
                            if core == "attention":
                                got["score"].append(math.prod(out))
                            if core == "mlstm":
                                got["width"].append(lhs[lc[0]])
                elif forward and op == "scatter" and len(out) == 4 \\
                        and "vmap()/scatter-add" in name:
                    got["dispatch"].append(out)
                elif forward and op == "gather" and "vmap()/gather" in name \\
                        and len(shapes[operands[0]]) == 4:
                    got["combine"].append([shapes[operands[0]], out])
                elif forward and op == "all-reduce" \\
                        and "vmap()/gather" in name:
                    got["combine_ar"].append(out)
            got["cores"] = {{k: sorted(v) for k, v in got["cores"].items()}}
            for k in ("score", "width"):
                got[k] = sorted(set(got[k]))
            for k in ("dispatch", "combine"):
                got[k] = sorted(set(map(json.dumps, got[k])))
            return c, got

        out = {{"smoke": {{}}, "cores": {{}}, "dots": {{}}, "flops": {{}}}}
        cfg = get_config("qwen3_8b").smoke()
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        for kind in {KINDS!r}:
            c, got = compile_cell(cfg, mesh, kind)
            out["smoke"][kind] = {{
                "args": int(c.memory_analysis().argument_size_in_bytes),
                "coll": R.collective_bytes_from_hlo(c.as_text())}}
            out["dots"]["qwen3_8b/2x4/" + kind] = got["dots"]
            if kind in {CORE_KINDS!r}:
                out["cores"]["qwen3_8b/2x4/" + kind] = got["cores"]
            c, got = compile_cell(cfg, mesh, kind, {SEQ_RULES!r})
            out["dots"]["qwen3_8b/2x4/" + kind + "/seq"] = got["dots"]
            out["smoke"][kind + "/seq"] = {{
                "args": int(c.memory_analysis().argument_size_in_bytes),
                "score": got["score"]}}
            c, got = compile_cell(get_config("dbrx_132b").smoke(), mesh, kind)
            out["dots"]["dbrx_132b/2x4/" + kind] = got["dots"]
            if kind == {MOE_CELL[2]!r}:
                out["moe"] = {{k: got[k] for k in ("dispatch", "combine",
                                                   "combine_ar")}}
        for arch, shape in {CORE_CELLS!r}:
            if arch == "qwen3_8b":
                continue
            mesh = compat_make_mesh(shape, ("data", "model"))
            for kind in {CORE_KINDS!r}:
                key = f"{{arch}}/{{shape[0]}}x{{shape[1]}}/{{kind}}"
                out["cores"][key] = compile_cell(
                    get_config(arch).smoke(), mesh, kind)[1]["cores"]
        arch, shape = {P_CUT_CELL!r}
        mesh = compat_make_mesh(shape, ("data", "model"))
        out["p_cut"] = {{}}
        for kind in {CORE_KINDS!r}:
            got = compile_cell(get_config(arch).smoke(), mesh, kind)[1]
            out["p_cut"][kind] = {{"cores": got["cores"]["mlstm"],
                                  "width": got["width"]}}
        shutil.rmtree(dump)
        for a in ARCH_IDS:
            for s in applicable_shapes(get_config(a)):
                out["flops"][a + "/" + s.name] = D.model_flops_for(
                    get_config(a), s)
        print(json.dumps(out))
    """)

@functools.lru_cache(maxsize=None)
def _port_side() -> dict:
    """The port on fake meshes: the same smoke cells traced (each core's
    function wrapped to record the batch x heads of rank 0's shard, the
    attention's score block and the mLSTM's P width; the MoE's dispatch
    and combine to record their local extents), the qwen3-8b cells' and
    the MoE cell's collectives by call site, and a ``Shard(0)`` x
    ``Shard(1)`` product on a fake 1-D mesh of 4."""
    return _run(f"""
        import json, math, torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed import tensor as dt
        from torch.distributed.tensor import Shard
        from repro_torch.configs import get_config
        from repro_torch.core.config import ShapeSpec
        from repro_torch.core.roofline import TraceCounter
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_mesh, smoke_mesh, teardown
        from repro_torch.models import attention, mlp, ssm
        out = {{"smoke": {{}}, "cores": {{}}, "dots": {{}}, "sites": {{}}}}
        seen, score, width, moe = {{}}, set(), set(), {{}}

        def record(core, fn):      # a (B, S, heads..., width) first input
            def run(x, *a, **k):
                seen.setdefault(core, set()).add(
                    x.numel() // (x.shape[1] * x.shape[-1]))
                if core == "attention":
                    score.add(x.numel() // x.shape[-1]
                              * k.get("chunk", a[0].shape[1]))
                if core == "mlstm":         # the P of v: the q.k part
                    width.add(a[1].shape[-1])
                return fn(x, *a, **k)
            return run
        for core, (_, mod, names) in {CORES!r}.items():
            mod = attention if mod == "attention" else ssm
            for name in names:
                setattr(mod, name, record(core, getattr(mod, name)))

        def extent(key, fn, at):   # a local shape of the MoE's
            def run(*a, **k):
                r = fn(*a, **k)
                moe.setdefault(key, set()).add(json.dumps(at(a, r)))
                return r
            return run
        mlp._dispatch = extent("dispatch", mlp._dispatch,
                               lambda a, r: list(r[0].shape))
        mlp._gather = extent("combine", mlp._gather,
                             lambda a, r: [list(a[0].shape), list(r.shape)])

        def cores():
            got = {{k: sorted(v) for k, v in seen.items()}}
            seen.clear()
            return got

        def trace(arch, mesh, kind, rules=None, sites=False):
            shape = ShapeSpec("smoke", 32, 8, kind)
            return D.trace_cell(get_config(arch).smoke(), shape, mesh,
                                D.cell_rules(mesh, shape, rules),
                                sites=sites)

        mesh = make_mesh((2, 4), ("data", "model"))
        for kind in {KINDS!r}:
            c, arg_bytes = trace("qwen3_8b", mesh, kind, sites=True)
            out["smoke"][kind] = {{"args": arg_bytes, "coll": c.coll,
                                  "ops": c.ops, "peak": c.peak,
                                  "sites": c.sites}}
            out["dots"]["qwen3_8b/2x4/" + kind] = sum(c.ops.values())
            out["cores"]["qwen3_8b/2x4/" + kind] = cores()
            score.clear()
            c, arg_bytes = trace("qwen3_8b", mesh, kind, {SEQ_RULES!r})
            out["dots"]["qwen3_8b/2x4/" + kind + "/seq"] = sum(
                c.ops.values())
            out["smoke"][kind + "/seq"] = {{"args": arg_bytes,
                                           "score": sorted(score)}}
            seen.clear()
            c, _ = trace("dbrx_132b", mesh, kind, sites=True)
            out["dots"]["dbrx_132b/2x4/" + kind] = sum(c.ops.values())
            if kind == {MOE_CELL[2]!r}:
                out["moe"] = {{k: sorted(v) for k, v in moe.items()}}
                out["moe"]["sites"] = c.sites
            moe.clear()
            seen.clear()
        for arch, shp in {CORE_CELLS!r} + ({P_CUT_CELL!r},):
            if arch == "qwen3_8b":
                continue
            if tuple(mesh.shape) != tuple(shp):
                teardown()
                mesh = make_mesh(shp, ("data", "model"))
            for kind in {CORE_KINDS!r}:
                width.clear()
                trace(arch, mesh, kind)
                got = cores()
                if (arch, tuple(shp)) == {P_CUT_CELL!r}:
                    out.setdefault("p_cut", {{}})[kind] = {{
                        "cores": got["mlstm"], "width": sorted(width)}}
                else:
                    out["cores"][f"{{arch}}/{{shp[0]}}x{{shp[1]}}/{{kind}}"] \\
                        = got
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


# where the port reduce-scatters and XLA's CPU pipeline all-reduces the
# same partial sum and slices it (it never forms a reduce-scatter: a
# partial product whose output is cut compiles to all-reduce +
# dynamic-slice), with the same operand bytes: the gradient of a forward
# all-gather, ZeRO-3's weight gathers (``unshard``) and ``matmul``'s
NAMED_RS = ("< unshard", "< matmul")


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_collectives_beside_jax(kind):
    """The gate on the dry run's collectives: the bytes a device of
    qwen3-8b ``smoke()`` on (2, 4), traced by the port, are at most those
    JAX's ``collective_bytes_from_hlo`` reads in XLA's HLO of the same
    cell with every layer unrolled; and the port reduce-scatters
    only the gradients of its forward all-gathers (``NAMED_RS``), where
    XLA's HLO, which holds no reduce-scatter, all-reduces the same bytes.
    ``pytest -s`` prints both by kind and the port's by call site."""
    port = _port_side()["smoke"][kind]
    jax_ = _jax_side()["smoke"][kind]["coll"]
    total, total_jax = sum(port["coll"].values()), sum(jax_.values())
    print(f"\n[collectives] qwen3-8b smoke {kind} (2, 4): port {total} B "
          f"{port['coll']}; JAX {total_jax} B {jax_}")
    for site, got in sorted(port["sites"].items(),
                            key=lambda kv: -sum(kv[1].values())):
        print(f"  {sum(got.values()):8d} {site} {got}")
    assert 0 < total <= total_jax
    assert jax_["reduce-scatter"] == 0
    unnamed = {site: got["reduce-scatter"]
               for site, got in port["sites"].items()
               if got.get("reduce-scatter")
               and not (site.startswith("grad of ")
                        and site.endswith(NAMED_RS))}
    assert not unnamed, unnamed


# the lines of the port's model that look the tokens' rows up in the
# embedding table (``_embed_tokens``, ``decode_step``)
LOOKUP_LINES = tuple(
    i for i, line in enumerate((SRC / "repro_torch" / "models" / "lm.py")
                               .read_text().splitlines(), 1)
    if 'params["embed"]' in line)


@pytest.mark.parametrize("kind", KINDS)
def test_smoke_embedding_lookup_on_the_table_shards(kind):
    """qwen3-8b ``smoke()`` on (2, 4): the table (512 x 64 fp32) cut over
    "model" by rows and over "data" by columns, 128 x 32 a rank, 16,384
    B; 4 sequences a rank. XLA's HLO looks the rows up on the table's
    shards in every step kind: it gathers the ids (its one all-gather
    there, s32), picks its own rows on its own columns for every id of
    the "data" group, and all-to-alls and all-reduces the pieces. The
    port's lookup (``sharding.take_rows``) does the same where that moves
    fewer bytes than gathering the table's columns: in decode and train
    the collectives at the lookup are the ids' gather (4 x S int32) and
    the all-to-all of the rows for the other rank (4 x S x 32 fp32, in
    train its gradient back too), no gather of the table and no
    reduce-scatter of its gradient; in prefill the exchange would move
    the ids' 512 B more than the table's 16,384, and the port gathers
    the table's shard as before."""
    S = 1 if kind == "decode" else 32
    ids, rows, table = 4 * S * 4, 4 * S * 32 * 4, 128 * 32 * 4
    at = {}
    for site, got in _port_side()["smoke"][kind]["sites"].items():
        where = site.removeprefix("grad of ").split(" ")[0]
        if where in {f"models/lm.py:{i}" for i in LOOKUP_LINES}:
            for k, v in got.items():
                at[k] = at.get(k, 0) + v
    grad = kind == "train"
    print(f"\n[lookup] qwen3-8b smoke {kind} (2, 4), lines {LOOKUP_LINES}:"
          f" {at}")
    if kind == "prefill":
        assert ids + rows > table
        assert at.get("all-gather") == table and not at.get("all-to-all")
    else:
        assert ids + rows * (1 + grad) < table * (1 + 2 * grad)
        assert at.get("all-gather") == ids
        assert at.get("all-to-all") == rows * (1 + grad)
    assert not at.get("reduce-scatter")


# the decode step's one token leaves no sequence to cut, and the port's
# step is the default rules' (equal to XLA's 229,376 products there); with
# the sequence rule GSPMD gathers the MLP's weights whole for that token
# and runs 376,832, so the seq cell's decode is not held
DOT_IDS = [_cell_key(a, m, k, r) for a, m, r in DOT_CELLS for k in KINDS
           if not (r and k == "decode")]


@pytest.mark.parametrize("cell", DOT_IDS)
def test_smoke_products_equal_xla_dots(cell):
    """Rank 0's products a device (the trace's counter) equal the dots of
    XLA's HLO after its SPMD partitioner (2 x output x contraction each),
    forward, backward and serving, the sequence cut included: the port
    computes what each device of JAX's program computes, no more."""
    assert _port_side()["dots"][cell] == _jax_side()["dots"][cell]


@pytest.mark.parametrize("kind", KINDS)
def test_seq_cut_cell_arguments_and_core_as_jax(kind):
    """qwen3-8b ``smoke()`` on (2, 4) with the sequence cut over "model"
    (F4): the argument bytes a device equal XLA's, and each attention
    core's score block on rank 0 (batch x queries x heads x keys of a KV
    chunk) equals the output of XLA's dot of the same core: each rank its
    own queries, every head, as GSPMD cuts it."""
    port = _port_side()["smoke"][kind + "/seq"]
    jax_ = _jax_side()["smoke"][kind + "/seq"]
    assert port["args"] == jax_["args"]
    assert port["score"] == jax_["score"]
    assert kind == "decode" or port["score"]


def test_moe_dispatch_and_combine_as_jax():
    """dbrx-132b ``smoke()`` on (2, 4), prefill: each rank scatters its
    tokens into its own expert's queues only, (G, 1 expert of 4, C, D) as
    XLA's scatter, and the combine gathers each choice's row from the
    rank's own expert, (G, T K, D) out of (G, 1, C, D) as XLA's gather,
    the shares summed by all-reduces of XLA's bytes."""
    port, jax_ = _port_side()["moe"], _jax_side()["moe"]
    assert port["dispatch"] == jax_["dispatch"] and port["dispatch"]
    assert port["combine"] == jax_["combine"] and port["combine"]
    ar = sum(got.get("all-reduce", 0) for site, got in port["sites"].items()
             if site.endswith(" moe_forward < shard")
             and not site.startswith("grad of"))
    assert ar == sum(4 * math.prod(s) for s in jax_["combine_ar"]) > 0


@pytest.mark.parametrize("kind", CORE_KINDS)
def test_mlstm_p_cut_as_jax(kind):
    """xlstm-125m ``smoke()`` on (1, 16): 4 mLSTM heads over 16 model
    ranks, where GSPMD cuts each head's P over 4 of them; rank 0's scan
    runs the batch x 1 head and 4 of P's 16, the extent and contraction
    width of XLA's q.k dot (xlstm-125m at TP 16: 1 head x 48 of 192)."""
    port, jax_ = _port_side()["p_cut"][kind], _jax_side()["p_cut"][kind]
    assert port["cores"] == jax_["cores"]
    assert port["width"] == jax_["width"] == [4]


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
