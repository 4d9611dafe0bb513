"""The port's models on real DTensors: gloo processes on a CPU mesh, the
parameters and batch laid out by ``param_shardings`` and
``batch_sharding``, every step run inside ``sharding_ctx`` (with
``implicit_replication``: a tensor the model makes, a mask or an
``arange``, is whole on every rank), and each result's ``full_tensor()``
held against the same step on plain tensors in the same process.

The dry run only traces these paths on fake tensors; here the explicit
redistributes (``unflatten``, ``align``, ``per_shard``, ``take_last``,
``unshard``, ``full``, ``put_prefix`` and ``shard``'s cotangent) and the
layouts GSPMD chooses (``matmul``'s gathered weights and all-reduced
partial sums, ``chunk``'s all-to-all, the MoE's expert-local dispatch and
masked combine, the mLSTM's (head, P) pieces) compute real numbers, so a
wrong offset, layout or gradient shows. Meshes: (2, 1) cuts the batch,
(1, 2) the heads, the vocab, the ffn and the experts, (2, 2) both, and
(1, 4) the query heads and the SSM heads four ways (GQA's 2 KV heads stay
whole: ``unflatten`` gathers them), one a rank, and in test-only variants
otherwise (``VARIANTS``): unevenly, each mLSTM head's P cut, and the
sequence cut over "model". Each smoke config, fp32, batch 4 x 32 tokens.

Tolerances (fp32; sums in another order): the forward's logits, the
prefill's last logits and one decode step's logits within 1e-5 x
max|plain|; the loss within 1e-5 relative; each cache leaf (a recurrent
state sums over the 32 tokens), each gradient leaf (a sum over the batch)
and, after one ``adamw_update``, each first and second moment within
1e-4 x its max|plain|; each parameter within 2 x lr + 1e-6 (Adam's first
step moves an element by lr x sign(g), so a gradient element near zero
may flip sides under a new summation order).
"""
import functools
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

# mesh -> the smoke configs run on it
RUNS = {(2, 1): ("qwen3_8b", "dbrx_132b", "zamba2_1p2b", "xlstm_125m"),
        (1, 2): ("qwen3_8b", "dbrx_132b", "zamba2_1p2b", "xlstm_125m"),
        (2, 2): ("dbrx_132b",),
        (1, 4): ("qwen3_8b", "zamba2_1p2b", "xlstm_125m", "qwen3_gqa6",
                 "xlstm_h2", "xlstm_h1", "qwen3_seq", "dbrx_seq")}
# test-only configs: a smoke config with fields replaced, and rules over
# the defaults. qwen3_gqa6 has 6 query heads over 2 KV heads (groups of
# 3): on 4 model ranks the heads fall in ceil chunks of 2, so rank 0's
# lie inside a group, rank 1's straddle two, and rank 3 holds none.
# xlstm_h2's 2 mLSTM heads and xlstm_h1's 1 are each cut with P over 2
# and 4 ranks (each rank a piece of a head's P, as GSPMD cuts xlstm-125m's
# 4 heads on TP 16). qwen3_seq and dbrx_seq cut the sequence over "model"
# (the hill climb's sequence-parallel iterations); dbrx_seq in 2 token
# groups, one expert a rank
VARIANTS = {"qwen3_gqa6": ("qwen3_8b", {"n_heads": 6, "n_kv_heads": 2}, {}),
            "xlstm_h2": ("xlstm_125m", {"n_heads": 2, "n_kv_heads": 2}, {}),
            "xlstm_h1": ("xlstm_125m", {"n_heads": 1, "n_kv_heads": 1}, {}),
            "qwen3_seq": ("qwen3_8b", {}, {"seq": ["model"]}),
            "dbrx_seq": ("dbrx_132b", {"moe_groups": 2}, {"seq": ["model"]})}
CASES = [(m, a) for m, archs in RUNS.items() for a in archs]
OUT_RTOL, SUM_RTOL = 1e-5, 1e-4

_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                         adamw_update, init_adamw)
    from repro_torch.parallel.sharding import (DEFAULT_RULES,
                                               batch_sharding, named,
                                               param_shardings, sharding_ctx)
    from repro_torch.train.steps import (loss_and_grads, serve_decode,
                                         serve_prefill)
    VARIANTS = json.loads(sys.argv[7])

    torch.set_num_threads(1)
    rank, world, url, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    shape = tuple(map(int, sys.argv[5].split("x")))
    dist.init_process_group("gloo", init_method=url, rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    B, S, S_MAX = 4, 32, 40
    OCFG = AdamWConfig(state_dtype="float32")

    def leaves(tree):
        if isinstance(tree, dict):
            return [a for _, a in lm.tree_leaves(tree)]
        if isinstance(tree, (tuple, list)):
            return [a for t in tree for a in leaves(t)]
        return [tree]

    def whole(x):      # a collective: every rank calls it
        return x.full_tensor() if isinstance(x, DTensor) else x

    def place(tree, shardings):
        return lm.tree_map(lambda a, s: distribute_tensor(
            a.clone(), s.mesh, s.placements), tree, shardings)

    def step(params, batch, opt, dec_tok):
        # the serving steps first: adamw_update writes the parameters in
        # place, and its first step may move an element the two runs
        # round to either side of zero by 2 x lr apart
        with torch.no_grad():
            logits = lm.forward(params, batch["tokens"], cfg)
        _, last, cache = serve_prefill(params, {"tokens": batch["tokens"]},
                                       cfg, S_MAX)
        _, dec, _ = serve_decode(params, dec_tok, cache, cfg)
        loss, grads = loss_and_grads(params, batch, cfg)
        _, opt, metrics = adamw_update(grads, opt, params, OCFG)
        return {"logits": [logits], "last": [last], "cache": leaves(cache),
                "decode": [dec], "loss": [loss], "grads": leaves(grads),
                "m": leaves(opt.m), "v": leaves(opt.v),
                "params": leaves(params), "lr": [metrics["lr"]]}

    res = {}
    for arch in sys.argv[6].split(","):
        name, over, seq = VARIANTS.get(arch, (arch, {}, {}))
        cfg = dataclasses.replace(get_config(name).smoke(), **over)
        rules = dict(DEFAULT_RULES, **{k: tuple(v) for k, v in seq.items()})
        params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.RandomState(0)
        batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab, (B, S))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        dec_tok = torch.from_numpy(rng.randint(0, cfg.vocab, (B, 1))
                                   .astype(np.int32))
        want = step(lm.tree_map(torch.clone, params), batch,
                    init_adamw(params, OCFG), dec_tok)

        sh = param_shardings(mesh, rules, params)
        bs = {k: batch_sharding(mesh, tuple(v.shape), rules)
              for k, v in (("tokens", batch["tokens"]), ("dec", dec_tok))}
        opt = init_adamw(params, OCFG)
        with sharding_ctx(mesh, rules), implicit_replication():
            got = step(
                place(params, sh),
                {k: distribute_tensor(v, mesh, bs["tokens"].placements)
                 for k, v in batch.items()},
                AdamWState(distribute_tensor(
                    opt.step, mesh, named(mesh, rules, ()).placements),
                    place(opt.m, sh), place(opt.v, sh)),
                distribute_tensor(dec_tok, mesh, bs["dec"].placements))
        for key, ws in want.items():
            gs = [whole(g) for g in got[key]]
            assert len(gs) == len(ws), (arch, key)
            assert [g.shape for g in gs] == [w.shape for w in ws], (arch, key)
            res[arch + "/" + key] = np.array(
                [[(g.double() - w.double()).abs().max().item(),
                  w.double().abs().max().item()] for g, w in zip(gs, ws)
                 if w.numel()])
    np.savez(out % rank, **res)
    dist.destroy_process_group()
""")


# the lookup alone (``sharding.take_rows``): a V x D table cut over
# "model" by rows and over "data" by columns, the ids' batch over "data"
LOOKUP_MESHES = ((2, 2), (1, 4), (4, 1))
LOOKUP_V, LOOKUP_D = 32, 8

_LOOKUP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np, torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import (DEFAULT_RULES, batch_sharding,
                                               named, sharding_ctx, shard,
                                               take_rows)

    torch.set_num_threads(1)
    rank, world, url, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    shape = tuple(map(int, sys.argv[5].split("x")))
    V, D = int(sys.argv[6]), int(sys.argv[7])
    dist.init_process_group("gloo", init_method=url, rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    gathers = []                   # the table gathered: not this lookup
    unshard = sharding.unshard
    sharding.unshard = lambda *a, **k: gathers.append(1) or unshard(*a, **k)

    rng = np.random.RandomState(0)
    table = torch.from_numpy(rng.randn(V, D).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 3, D).astype(np.float32))
    m = V // shape[1]              # a model rank's rows
    edges = sorted({0, V - 1} | {k + d for k in range(m, V, m)
                                 for d in (-1, 0)})
    ids = (edges + edges[::-1])[:12]          # each edge, most twice
    tokens = torch.tensor(ids + list(rng.randint(0, V, 12 - len(ids))),
                          dtype=torch.int32).reshape(4, 3)
    t = distribute_tensor(table.clone(), mesh, named(
        mesh, DEFAULT_RULES, (V, D), "vocab", "fsdp").placements)
    t.requires_grad_(True)
    tok = distribute_tensor(tokens, mesh, batch_sharding(
        mesh, (4, 3)).placements)
    with sharding_ctx(mesh):
        with torch.no_grad():
            served = take_rows(t, tok).full_tensor()
        y = shard(take_rows(t, tok), "batch", "seq", "embed")
        y.backward(distribute_tensor(g, mesh, y.placements))
    want = F.embedding(tokens.long(), table)
    scatter = torch.zeros(V, D).index_add_(0, tokens.reshape(-1).long(),
                                           g.reshape(-1, D))
    res = {"served": torch.equal(served, want),
           "forward": torch.equal(y.full_tensor(), want),
           "grad": torch.equal(t.grad.full_tensor(), scatter),
           "placements": str(t.grad.placements) == str(t.placements),
           "gathers": len(gathers)}
    if rank == 0:
        with open(out, "w") as f:
            f.write(repr(res))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def _run(mesh):
    """Rank 0's (max|sharded - plain|, max|plain|) rows, one a leaf, by
    "arch/quantity", from ``len(mesh)`` gloo processes."""
    world = mesh[0] * mesh[1]
    out = Path(os.environ.get("TMPDIR", "/tmp")) / (
        f"sharded_{os.getpid()}_{mesh[0]}x{mesh[1]}_rank%d.npz")
    url = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), url, str(out),
         f"{mesh[0]}x{mesh[1]}", ",".join(RUNS[mesh]),
         json.dumps(VARIANTS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    got = dict(np.load(str(out) % 0))
    for r in range(world):
        os.remove(str(out) % r)
    return got


@functools.lru_cache(maxsize=None)
def _lookup(mesh):
    """Rank 0's checks of the lookup on ``mesh``, from gloo processes."""
    world = mesh[0] * mesh[1]
    out = Path(os.environ.get("TMPDIR", "/tmp")) / (
        f"lookup_{os.getpid()}_{mesh[0]}x{mesh[1]}.txt")
    url = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOOKUP_WORKER, str(r), str(world), url,
         str(out), f"{mesh[0]}x{mesh[1]}", str(LOOKUP_V), str(LOOKUP_D)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-4000:]
    got = eval(out.read_text())
    out.unlink()
    return got


_LOOKUP_IDS = [f"{m[0]}x{m[1]}" for m in LOOKUP_MESHES]


@pytest.mark.parametrize("mesh", LOOKUP_MESHES, ids=_LOOKUP_IDS)
def test_lookup_on_the_table_shards_is_bit_equal(mesh):
    """``take_rows`` on a table cut by rows over "model" and by columns
    over "data", ids at every model rank's edges (0, V/m - 1, V/m, V - 1)
    and repeated: served (no gradient) and in training, the rows equal
    ``F.embedding``'s bit for bit (each row summed from one rank's pick
    and the others' zeros), and the table is never gathered."""
    got = _lookup(mesh)
    assert got["served"] and got["forward"]
    assert got["gathers"] == 0


@pytest.mark.parametrize("mesh", LOOKUP_MESHES, ids=_LOOKUP_IDS)
def test_lookup_gradient_is_the_plain_scatter_add(mesh):
    """The table's gradient, laid out as the table, equals the plain
    scatter-add of the rows' gradient into the whole table (each row's
    sum in the ids' order, as ``index_add_`` takes them)."""
    got = _lookup(mesh)
    assert got["grad"] and got["placements"]


def _rel(rows):
    """Each leaf's max|sharded - plain| over its max|plain|."""
    return rows[:, 0] / np.maximum(rows[:, 1], 1e-30)


_IDS = [f"{m[0]}x{m[1]}-{a}" for m, a in CASES]


@pytest.mark.parametrize("mesh,arch", CASES, ids=_IDS)
def test_sharded_forward_prefill_and_decode_match_plain(mesh, arch):
    """Logits, the prefill's last logits, every cache leaf (its KV slots
    written through ``put_prefix``) and a decode step's logits."""
    res = _run(mesh)
    for key in ("logits", "last", "decode"):
        rel = _rel(res[f"{arch}/{key}"])
        assert rel.max() <= OUT_RTOL, (key, rel)
    rel = _rel(res[f"{arch}/cache"])
    assert rel.max() <= SUM_RTOL, rel


@pytest.mark.parametrize("mesh,arch", CASES, ids=_IDS)
def test_sharded_loss_and_gradients_match_plain(mesh, arch):
    res = _run(mesh)
    assert _rel(res[f"{arch}/loss"]).max() <= OUT_RTOL
    rel = _rel(res[f"{arch}/grads"])
    assert len(rel) > 4 and rel.max() <= SUM_RTOL, rel


@pytest.mark.parametrize("mesh,arch", CASES, ids=_IDS)
def test_sharded_adamw_step_matches_plain(mesh, arch):
    res = _run(mesh)
    for key in ("m", "v"):
        rel = _rel(res[f"{arch}/{key}"])
        assert rel.max() <= SUM_RTOL, (key, rel)
    lr = res[f"{arch}/lr"][0, 1]
    assert lr > 0
    assert res[f"{arch}/params"][:, 0].max() <= 2 * lr + 1e-6
