"""Multi-pod dry run: trace every (arch x shape) cell on the production
meshes with fake tensors (nothing allocated), print the per-device costs,
and persist the roofline terms.

The JAX package's ``launch/dryrun.py`` lowers each cell to XLA on 256 or
512 forced host devices and reads XLA's memory analysis, cost analysis and
HLO collectives. torch has no GSPMD, so the port traces instead: the mesh
is a ``DeviceMesh`` over the ``fake`` process group (``launch/mesh.py``),
this process is its rank 0, the state and batch are DTensors of fake
tensors laid out by ``parallel/sharding.py``, and the cell's step
(``train_step``, ``serve_prefill`` or ``serve_decode``) runs once under
``FakeTensorMode`` and ``implicit_replication`` (a plain tensor the model
makes, an ``arange`` or a mask, is replicated, as an XLA constant is).
A :class:`~repro_torch.core.roofline.TraceCounter` sees rank 0's local
ops and gives:

* flops a device: the products (what phase 17 of ``chip_smoke.py``
  counts), not XLA's every-op flops;
* argument bytes a device: exact, from the local shard shapes;
* collective bytes a device, by kind: each functional collective's
  operand bytes, as JAX's ``collective_bytes_from_hlo`` sums operands;
* peak bytes a device: the live-bytes high-water mark of the eager trace,
  arguments included. XLA's ``temp_size`` is a buffer assignment of the
  fused, scheduled program; the eager step keeps every unfused
  intermediate until its last use, so it reads higher.
  ``temp_bytes_per_device`` here is that peak less the arguments.

Rank 0 holds the largest shard where a split is uneven, so its numbers
are the busiest device's. Every layer runs (Python loops), so JAX's layer
extrapolation (``run_cell_scaled``, ``_cost_point``, ``--scaled``,
``--unroll``) has no purpose here and is left out.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import roofline as R
from repro_torch.core.config import (ModelConfig, ShapeSpec,
                                     applicable_shapes, get_shape)
from repro_torch.launch.mesh import (make_production_mesh, rules_for_mesh,
                                     teardown)
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, AdamWState
from repro_torch.parallel.sharding import (DEFAULT_RULES, named,
                                           param_shardings, sharding_ctx)
from repro_torch.train.steps import (TrainState, init_train_state,
                                     serve_decode, serve_prefill, train_step)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def model_flops_for(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS: 6·N_active·D (train) / 2·N_active·D (serve) plus the
    attention-over-KV term, which dominates decode and is real model work
    (score + PV matmuls over the cache; causal halves the full-seq case).
    """
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S if shape.kind != "decode" else B
    mult = 6 if shape.kind == "train" else 2
    flops = mult * n_active * tokens

    if cfg.family in ("dense", "vlm", "audio", "moe"):
        hq, dh, L = cfg.n_heads, cfg.d_head, cfg.n_layers
    elif cfg.family == "hybrid":                   # shared attn applications
        hq, dh, L = cfg.n_heads, cfg.d_head, lm.n_shared_attn_apps(cfg)
    else:                                          # ssm: no KV attention
        hq = dh = L = 0
    if L:
        if shape.kind == "decode":                 # q=1 against S cache
            attn = 4 * B * S * hq * dh * L
        else:                                      # causal full sequence
            attn = 4 * B * S * S * hq * dh * L / 2
            attn *= 3 if shape.kind == "train" else 1   # fwd+bwd
        flops += attn
    return float(flops)


def _is_axes_leaf(x) -> bool:
    """A logical-axes leaf is a plain tuple of axis names (or empty),
    NOT a NamedTuple like DecodeCache/KVCache (those are containers)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def _map_axes(fn: Callable, axes, tree):
    """``fn(axes_leaf, tensor)`` over a logical-axes tree and the tensor
    tree of the same structure (dicts and NamedTuples)."""
    if _is_axes_leaf(axes):
        return fn(axes, tree)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, axes[k], v) for k, v in tree.items()}
    return type(tree)(*(_map_axes(fn, a, t) for a, t in zip(axes, tree)))


def _placed(t: torch.Tensor, sharding) -> torch.Tensor:
    """A DTensor of ``t``'s shape and dtype under ``sharding``, holding
    only this rank's shard (fake under ``FakeTensorMode``)."""
    from torch.distributed import tensor as dt
    return dt.empty(tuple(t.shape), dtype=t.dtype,
                    device_mesh=sharding.mesh,
                    placements=sharding.placements)


def _placed_tree(axes_tree, specs, mesh, rules):
    def one(axes, t):
        if t.ndim != len(axes):
            axes = (None,) * t.ndim
        return _placed(t, named(mesh, rules, t.shape, *axes))
    return _map_axes(one, axes_tree, specs)


def _placed_params(params, mesh, rules):
    shardings = param_shardings(mesh, rules, params)
    return lm.tree_map(_placed, params, shardings)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules
               ) -> Tuple[Callable, tuple]:
    """(step, its arguments): the state or parameters and the batch as
    DTensors laid out by ``rules`` on ``mesh``. Call inside
    ``FakeTensorMode`` and ``sharding_ctx``."""
    specs = lm.input_specs(cfg, shape)
    batch_ax = lm.batch_logical_axes(cfg, shape.kind)
    batch = _placed_tree(batch_ax, specs, mesh, rules)
    meta = torch.device("meta")
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)

    if shape.kind == "train":
        st = init_train_state(cfg, torch.Generator(), ocfg, device=meta)
        state = TrainState(
            _placed_params(st.params, mesh, rules),
            AdamWState(_placed(st.opt.step, named(mesh, rules, ())),
                       _placed_params(st.opt.m, mesh, rules),
                       _placed_params(st.opt.v, mesh, rules)))

        def fn(state, batch):
            return train_step(state, batch, cfg, ocfg)
        return fn, (state, batch)

    params = _placed_params(lm.init_params(cfg, torch.Generator(), meta),
                            mesh, rules)
    if shape.kind == "prefill":
        def fn(params, batch):
            return serve_prefill(params, batch, cfg, shape.seq_len)
        return fn, (params, batch)

    def fn(params, batch):
        return serve_decode(params, batch["tokens"], batch["cache"], cfg)
    return fn, (params, batch)


def _local_leaves(tree):
    """The local tensors of every DTensor leaf of ``tree``."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _local_leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree.to_local()


@contextmanager
def _dtensor_internals(counter: R.TraceCounter):
    """Two of DTensor's internals run uncounted while a cell is traced:

    * ``ShardingPropagator._propagate_tensor_meta_non_cached`` learns an
      op's output shape by running it on global-shaped fake tensors under
      the running fake mode, which no rank holds;
    * ``_StridedShard.local_shard_size_and_offset`` (where torch has it)
      calls ``tolist()`` on an ``arange`` of the dim, which fails under
      ``FakeTensorMode``; it runs on real tensors, once for each distinct
      set of arguments (a few ints; the strategy search asks again and
      again).

    And the redistribute planner (``_gen_transform_infos_non_cached``, a
    function of the two specs alone) is memoised: torch caches it only
    outside fake mode, and the strategy search on the 3-D mesh asks for
    the same plans (a graph search apiece) millions of times.
    """
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def paused(fn, real: bool):
        memo: Dict[Any, Any] = {}

        def run(*a, **k):
            key = (a, tuple(sorted(k.items()))) if real else None
            if key in memo:
                return memo[key]
            was, counter.paused = counter.paused, True
            try:
                if not real:
                    return fn(*a, **k)
                with unset_fake_temporarily():
                    memo[key] = fn(*a, **k)
                return memo[key]
            finally:
                counter.paused = was
        return run

    def memoised(fn):
        memo: Dict[Any, Any] = {}

        def run(*a, **k):
            key = (a, tuple(sorted(k.items())))
            if key not in memo:
                memo[key] = fn(*a, **k)
            return memo[key]
        return run

    patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                lambda fn: paused(fn, False))]
    strided = getattr(placement_types, "_StridedShard", None)
    if strided is not None and "local_shard_size_and_offset" in vars(strided):
        patches.append((strided, "local_shard_size_and_offset",
                        lambda fn: paused(fn, True)))
    if hasattr(_redistribute, "_gen_transform_infos_non_cached"):
        patches.append((_redistribute, "_gen_transform_infos_non_cached",
                        memoised))
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, wrap in patches:
        setattr(owner, name, wrap(getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
               run: bool = True, sites: bool = False
               ) -> Tuple[R.TraceCounter, int]:
    """Run the cell's step once on rank 0 of ``mesh`` under fake tensors:
    (its :class:`~repro_torch.core.roofline.TraceCounter`, the argument
    bytes a device). With ``run=False`` only the arguments are built (the
    counter holds them as live bytes); with ``sites``, the counter's
    ``sites`` name each collective's call site, a backward's too (the
    step runs under autograd's anomaly mode, which keeps each node's
    forward traceback)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    counter = R.TraceCounter(sites=sites)
    with FakeTensorMode(), sharding_ctx(mesh, rules), \
            implicit_replication(), _dtensor_internals(counter):
        fn, args = build_cell(cfg, shape, mesh, rules)
        local = list(_local_leaves(args))
        counter.track(local)
        arg_bytes = sum(t.numel() * t.element_size() for t in local)
        del local
        if run:
            with counter, torch.autograd.set_detect_anomaly(
                    sites, check_nan=False):
                fn(*args)
    return counter, arg_bytes


def cell_rules(mesh, shape: ShapeSpec, rules_over: Optional[dict] = None
               ) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    rules.update(rules_for_mesh(
        mesh, seq_shard_batch1=(shape.global_batch == 1)))
    if rules_over:
        rules.update(rules_over)
    return rules


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, cfg_over: Optional[dict] = None,
             rules_over: Optional[dict] = None) -> dict:
    """Trace one cell on its production mesh -> the report's dict plus
    the memory figures. The fake process group is torn down after."""
    cfg = get_config(arch)
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    shape = get_shape(shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = cell_rules(mesh, shape, rules_over)
        t0 = time.time()   # repro: allow[RPA102] trace-cost stopwatch
        counter, arg_bytes = trace_cell(cfg, shape, mesh, rules)
        # repro: allow[RPA102] trace-cost stopwatch
        t_trace = time.time() - t0
        chips = mesh.size()
    finally:
        teardown()

    rep = R.analyze_trace(counter, arch=arch, shape=shape_name,
                          mesh_name=mesh_name, chips=chips,
                          model_flops=model_flops_for(cfg, shape))
    result = rep.to_dict()
    result.update(
        trace_s=round(t_trace, 1), argument_bytes_per_device=arg_bytes,
        temp_bytes_per_device=counter.peak - arg_bytes,
        peak_bytes_per_device=counter.peak,
        coll_count=dict(counter.coll_count), flops_by_dtype=dict(counter.ops),
        n_params=cfg.param_count(), n_active_params=cfg.active_param_count())
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"args={arg_bytes / 2**30:.2f}GiB "
              f"peak={counter.peak / 2**30:.2f}GiB/device")
        print(f"[dryrun] trace: flops/dev={rep.flops_per_device:.3e} "
              f"bytes/dev={rep.bytes_per_device:.3e} "
              f"coll_bytes/dev={rep.collective_bytes_per_device:.3e}")
        print(f"[dryrun] roofline: T_comp={rep.t_compute*1e3:.2f}ms "
              f"T_mem={rep.t_memory*1e3:.2f}ms "
              f"T_coll={rep.t_collective*1e3:.2f}ms "
              f"bottleneck={rep.bottleneck} "
              f"useful={rep.useful_flops_ratio:.2%} "
              f"roofline_frac={rep.roofline_fraction:.2%} "
              f"(trace {t_trace:.0f}s)")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cells = []
    meshes = [True, False] if args.both_meshes else [args.multi_pod]
    if args.all:
        for arch in ARCH_IDS:
            for shape in applicable_shapes(get_config(arch)):
                for mp in meshes:
                    cells.append((arch, shape.name, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    failures = []
    for arch, shape, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        out = OUT_DIR / f"{args.tag}__{arch}__{shape}__{mesh_name}.json"
        if args.skip_existing and out.exists():
            print(f"[dryrun] skip {out.name} (exists)")
            continue
        try:
            result = run_cell(arch, shape, mp)
            out.write_text(json.dumps(result, sort_keys=True, indent=1))
        except Exception as e:  # a failed cell is reported, the rest run
            failures.append((arch, shape, mesh_name, repr(e)))
            print(f"[dryrun] FAIL {arch} x {shape} x {mesh_name}: {e}")
            traceback.print_exc(limit=6)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        return 1
    print("\nall dry-run cells green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
