"""The port's logical-axis sharding (slice 8c) against the JAX package.

``spec_for`` on JAX's three cases and on every parameter, batch and cache
leaf of every arch at full size, for every applicable shape, on both
production meshes (a mesh is only its axis sizes here, as in JAX's own
test); the DTensor placements' local shapes and offsets on a (2, 4) mesh
against JAX's ``NamedSharding`` shard indices (both sides in
subprocesses: JAX needs 8 forced devices, the port a ``fake`` process
group); and ``shard`` and its helpers leaving plain tensors as they are.
Specs are compared entry for entry (a JAX ``PartitionSpec`` is a tuple).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.core.config import applicable_shapes as jax_applicable_shapes
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config
from repro_torch.core.config import get_shape
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.parallel import sharding as tsh

SRC = Path(__file__).resolve().parents[1] / "src"


class FakeMesh:
    """Axis sizes only: what ``spec_for`` and ``rules_for_mesh`` read, in
    both packages' spellings."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = self.mesh_dim_names = tuple(shape)


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


# -- JAX's three cases (tests/test_parallel.py) -------------------------------

@pytest.mark.parametrize("shape,logical,mesh,rules", [
    ((92553,), ("vocab",), {"data": 16, "model": 16}, {}),
    ((92672,), ("vocab",), {"data": 16, "model": 16}, {}),
    ((1, 16), ("batch", None), {"data": 16, "model": 16}, {}),
    ((8, 64, 64), ("experts", "fsdp", "ffn"), {"data": 4, "model": 4}, {}),
    ((256, 128), ("batch", None), {"pod": 2, "data": 16, "model": 16},
     {"batch": ("pod", "data")}),
    ((16, 8), ("batch", None), {"pod": 2, "data": 16, "model": 16},
     {"batch": ("pod", "data")}),
], ids=["odd_vocab", "even_vocab", "batch1", "no_duplicate_axes",
        "multi_axis_batch", "multi_axis_batch_drop"])
def test_spec_for_matches_jax_cases(shape, logical, mesh, rules):
    m = FakeMesh(mesh)
    want = tuple(jsh.spec_for(shape, logical, m,
                              dict(jsh.DEFAULT_RULES, **rules)))
    got = tsh.spec_for(shape, logical, m, dict(tsh.DEFAULT_RULES, **rules))
    assert got == want
    flat = [a for e in got if e for a in ((e,) if isinstance(e, str) else e)]
    assert len(flat) == len(set(flat))


def test_default_rules_equal_jax():
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh._PARAM_AXES == jsh._PARAM_AXES


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("batch1", [False, True])
def test_rules_for_mesh_equal_jax(mesh_name, batch1):
    m = FakeMesh(MESHES[mesh_name])
    assert tmesh.rules_for_mesh(m, seq_shard_batch1=batch1) == \
        jmesh.rules_for_mesh(m, seq_shard_batch1=batch1)


# -- every leaf of every cell -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.key(0),
                                                    jax_get_config(arch)))
    return [(tuple(p.key for p in path), leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    params = lm.init_params(get_config(arch), torch.Generator(), "meta")
    return list(lm.tree_leaves(params))


def _jax_tree_specs(axes_tree, shapes, mesh, rules):
    def one(axes, sds):
        if not _is_axes(axes) or sds.ndim != len(axes):
            axes = (None,) * sds.ndim
        return tuple(jsh.spec_for(sds.shape, axes, mesh, rules))
    specs = jax.tree.map(one, axes_tree, shapes, is_leaf=_is_axes)
    return [s for s in jax.tree.leaves(specs, is_leaf=_is_spec)]


def _port_tree_specs(axes_tree, tensors, mesh, rules):
    out = []

    def walk(axes, t):
        if _is_axes(axes):
            if t.ndim != len(axes):
                axes = (None,) * t.ndim
            out.append(tsh.spec_for(tuple(t.shape), axes, mesh, rules))
        elif isinstance(t, dict):
            for k in sorted(t):                 # JAX's flatten order
                walk(axes[k], t[k])
        else:
            for a, c in zip(axes, t):
                walk(a, c)
    walk(axes_tree, tensors)
    return out


def _is_axes(x):
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def _is_spec(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


CELLS = [(a, s.name, m) for a in ARCH_IDS
         for s in jax_applicable_shapes(jax_get_config(a))
         for m in sorted(MESHES)]


@pytest.mark.parametrize("arch,shape_name,mesh_name", CELLS,
                         ids=["-".join(c) for c in CELLS])
def test_every_leaf_spec_equals_jax(arch, shape_name, mesh_name):
    """Each parameter leaf (by its key path), and each batch and cache
    leaf of the cell's inputs (``input_specs`` under
    ``batch_logical_axes``), gets JAX's spec, argument-grade."""
    m = FakeMesh(MESHES[mesh_name])
    shape = get_shape(shape_name)
    rules = dict(jsh.DEFAULT_RULES)
    rules.update(jmesh.rules_for_mesh(
        m, seq_shard_batch1=shape.global_batch == 1))
    trules = dict(tsh.DEFAULT_RULES)
    trules.update(tmesh.rules_for_mesh(
        m, seq_shard_batch1=shape.global_batch == 1))
    assert trules == rules

    jp = {path: tuple(jsh.spec_for(leaf.shape, jsh.param_spec(
        [jax.tree_util.DictKey(k) for k in path], leaf), m, rules))
        for path, leaf in _jax_params(arch)}
    tp = {path: tsh.spec_for(tuple(leaf.shape), tsh.param_spec(path, leaf),
                             m, trules)
          for path, leaf in _port_params(arch)}
    assert tp == jp

    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jspecs = jlm.input_specs(jcfg, shape)
    tspecs = lm.input_specs(cfg, shape)
    jax_leaves = jax.tree.leaves(jspecs)
    port_leaves = [t for t in _leaves(tspecs)]
    assert [(tuple(a.shape), str(a.dtype)) for a in jax_leaves] == \
        [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
         for t in port_leaves]
    assert all(t.device.type == "meta" for t in port_leaves)
    assert _port_tree_specs(lm.batch_logical_axes(cfg, shape.kind), tspecs,
                            m, trules) == \
        _jax_tree_specs(jlm.batch_logical_axes(jcfg, shape.kind), jspecs,
                        m, rules)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple):
        for c in tree:
            yield from _leaves(c)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_logical_axes_equal_jax(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    j, t = jlm.cache_logical_axes(jcfg), lm.cache_logical_axes(cfg)
    assert type(t).__name__ == type(j).__name__ and t._fields == j._fields
    assert jax.tree.leaves(j, is_leaf=_is_axes) == \
        jax.tree.leaves(tuple(t), is_leaf=_is_axes)
    for kind in ("train", "prefill"):
        assert lm.batch_logical_axes(cfg, kind) == \
            jlm.batch_logical_axes(jcfg, kind)


# -- DTensor shards against JAX's shard indices --------------------------------

SPECS = [((16, 24), ("data", "model")), ((16, 24), (None, "model")),
         ((16, 24), ("model", "data")), ((16, 24), (("data", "model"), None)),
         ((8, 6, 12), (None, "data", "model")),
         ((8, 16), (None, ("data", "model")))]


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _jax_indices():
    return _run(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import json, jax, numpy as np
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.launch.mesh import compat_make_mesh
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        coord = {{d.id: [int(i) for i in ix]
                 for ix, d in np.ndenumerate(mesh.devices)}}
        out = []
        for shape, spec in {SPECS!r}:
            m = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
            out.append({{"%d,%d" % tuple(coord[d.id]):
                         [[s.start or 0, n if s.stop is None else s.stop]
                          for s, n in zip(ix, shape)]
                         for d, ix in m.items()}})
        print(json.dumps(out))
    """)


@functools.lru_cache(maxsize=None)
def _port_indices():
    return _run(f"""
        import json
        import torch.distributed as dist
        import torch.testing._internal.distributed.fake_pg
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor._utils import \\
            compute_local_shape_and_global_offset
        from repro_torch.parallel.sharding import placements
        out = [dict() for _ in {SPECS!r}]
        for r in range(8):
            dist.init_process_group("fake", store=dist.HashStore(), rank=r,
                                    world_size=8)
            mesh = init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model"))
            c = mesh.get_coordinate()
            for i, (shape, spec) in enumerate({SPECS!r}):
                n, off = compute_local_shape_and_global_offset(
                    shape, mesh, placements(spec, mesh))
                out[i]["%d,%d" % tuple(c)] = [[o, o + k]
                                             for o, k in zip(off, n)]
            dist.destroy_process_group()
        print(json.dumps(out))
    """)


@pytest.mark.parametrize("i", range(len(SPECS)),
                         ids=[str(s) for s in SPECS])
def test_local_shards_equal_jax_indices(i):
    """Every rank's local shape and offset on a fake (2, 4) mesh are JAX's
    shard indices at the same mesh coordinate, a dim cut over both axes
    (major to minor) included."""
    assert _port_indices()[i] == _jax_indices()[i]


def test_placements_refuse_axes_out_of_mesh_order():
    mesh = FakeMesh({"data": 2, "model": 4})
    with pytest.raises(ValueError, match="axis order"):
        tsh.placements((("model", "data"), None), mesh)


# -- no context: the port's own runs ------------------------------------------

def test_shard_and_helpers_leave_plain_tensors_alone():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert tsh.shard(x, "batch", "seq", "embed") is x
    assert tsh.unshard(x) is x and tsh.unshard({"a": x})["a"] is x
    assert tsh.align(x, x, 1) is x
    assert torch.equal(tsh.unflatten(x, 2, (2, 2)), x.unflatten(2, (2, 2)))
    idx = torch.tensor([[0, 3, 1], [2, 2, 0]])
    assert torch.equal(tsh.take_last(x, idx),
                       torch.gather(x, -1, idx[..., None])[..., 0])
    assert torch.equal(tsh.full((2, 3), 0.5, torch.float32, "cpu", "batch",
                                None), torch.full((2, 3), 0.5))
    assert tsh.per_shard(lambda a, b: a + b, x, x, dims=(0,),
                         shape=x.shape).equal(2 * x)


def test_take_rows_on_plain_tensors_is_f_embedding(monkeypatch):
    """``take_rows`` on a plain table, outside a context and inside one,
    is one call of ``F.embedding`` on the same arguments."""
    table = torch.arange(40.0).reshape(10, 4)
    ids = torch.tensor([[0, 9, 3], [3, 3, 1]], dtype=torch.int32)
    calls = []
    embedding = torch.nn.functional.embedding
    monkeypatch.setattr(torch.nn.functional, "embedding",
                        lambda i, t: calls.append((i, t)) or embedding(i, t))
    with tsh.sharding_ctx(FakeMesh({"data": 2, "model": 4})):
        inside = tsh.take_rows(table, ids)
    assert torch.equal(tsh.take_rows(table, ids), inside)
    assert torch.equal(inside, embedding(ids, table))
    assert len(calls) == 2 and all(i is ids and t is table for i, t in calls)


def test_forward_is_bit_equal_inside_and_outside_a_context():
    """Plain tensors inside ``sharding_ctx`` see every annotation as a
    no-op: the forward and the loss are bit-equal to a run outside it."""
    cfg = get_config("qwen3_8b").smoke()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab, (2, 24)))
    batch = {"tokens": tok, "labels": torch.roll(tok, 1, 1)}
    want = lm.forward(params, tok, cfg), lm.loss_fn(params, batch, cfg)
    with tsh.sharding_ctx(FakeMesh({"data": 2, "model": 4})):
        got = lm.forward(params, tok, cfg), lm.loss_fn(params, batch, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_param_shardings_tree_follows_params():
    """``param_shardings`` gives one NamedSharding a leaf, in the tree of
    the parameters, with the spec ``param_spec`` and ``spec_for`` give."""
    cfg = get_config("dbrx_132b").smoke()
    params = lm.init_params(cfg, torch.Generator(), "meta")
    mesh = FakeMesh({"data": 2, "model": 4})
    sh = tsh.param_shardings(mesh, tsh.DEFAULT_RULES, params)
    for path, leaf in lm.tree_leaves(params):
        s = sh
        for k in path:
            s = s[k]
        assert s.spec == tsh.spec_for(tuple(leaf.shape), tsh.param_spec(
            path, leaf), mesh, tsh.DEFAULT_RULES)
        assert len(s.placements) == 2
