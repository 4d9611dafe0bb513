"""Logical-axis sharding: models annotate tensors with logical names
("batch", "seq", "heads", ...) and this module maps them onto the mesh
axes of a ``DeviceMesh``, with automatic divisibility fallback.

A copy of the JAX package's ``parallel/sharding.py`` over DTensor. A
sharding is JAX's ``PartitionSpec`` as a plain tuple, one entry a tensor
dimension: ``None``, a mesh axis name, or a tuple of names (the dimension
cut over several axes, major to minor). :func:`placements` turns it into
DTensor's ``Shard``/``Replicate`` placements, one a mesh dimension.

Why auto-drop: argument shardings must divide the dimension exactly.
Several configs have awkward dims (InternVL2's vocab is 92,553, long_500k
has batch 1, GQA kv_heads=8 never divide TP=16). ``spec_for`` drops mesh
axes that do not divide, so one rule set serves every (arch x shape x
mesh) cell.

Models call :func:`shard`, a no-op outside :func:`sharding_ctx` and on a
tensor that is not a DTensor: the port's own runs on one card never see
it. Inside, it redistributes to the spec, as JAX's
``with_sharding_constraint`` does; where GSPMD reshapes a tensor whose
shards do not hold whole pieces of the new dimension, DTensor refuses, and
:func:`unflatten` (or :func:`flatten`) gathers that dimension first (the
collective GSPMD inserts without saying so).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

AxisRule = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisRule, ...]

__all__ = ["DEFAULT_RULES", "align", "AxisRule", "batch_sharding", "chunk",
           "current_mesh", "flatten", "full", "group_gather", "group_sum",
           "matmul", "mesh_shape", "named", "NamedSharding",
           "param_shardings", "param_spec", "parts_group", "per_shard",
           "pieces", "placements", "put_prefix", "shard", "sharding_ctx",
           "Spec", "spec_for", "take_last", "take_rows", "unflatten",
           "unshard"]

# Default logical-axis -> mesh-axis rules (single pod). launch/mesh.py
# extends "batch" with the "pod" axis for the multi-pod mesh.
DEFAULT_RULES: Dict[str, AxisRule] = {
    "batch": ("data",),
    "seq": None,
    "kvseq": ("model",),       # SP decode: KV-cache sequence over TP axis
    "heads": ("model",),
    "embed": None,
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "fsdp": ("data",),         # ZeRO-3 param axis
    "tp": ("model",),          # tensor-parallel param axis
    "layers": None,
    "state": None,
}


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a mesh and a spec, with the spec's DTensor
    placements (``distribute_tensor(t, s.mesh, s.placements)``)."""
    mesh: Any
    spec: Spec
    placements: tuple


class _Ctx(threading.local):
    mesh = None
    rules: Optional[Dict[str, AxisRule]] = None


_CTX = _Ctx()


@contextmanager
def sharding_ctx(mesh, rules: Optional[Dict[str, AxisRule]] = None):
    prev = (_CTX.mesh, _CTX.rules)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.mesh, _CTX.rules = mesh, merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s, or a mesh whose ``shape`` is
    already that mapping (JAX's ``Mesh.shape``)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Dict[str, AxisRule],
             allow_uneven: bool = False) -> Spec:
    """The spec of ``shape`` under ``logical``, dropping axes that don't
    divide the dim."""
    sizes = mesh_shape(mesh)
    entries = []
    used: set = set()                     # a mesh axis may appear only once
    for dim, name in zip(shape, logical):
        rule = rules.get(name) if name else None
        if rule is None:
            entries.append(None)
            continue
        axes = (rule,) if isinstance(rule, str) else tuple(rule)
        # keep the largest prefix of unused mesh axes that divides this dim
        kept = []
        prod = 1
        for a in axes:
            if a not in sizes or a in used:
                continue
            nxt = prod * sizes[a]
            if allow_uneven or dim % nxt == 0:
                kept.append(a)
                prod = nxt
        used.update(kept)
        entries.append(tuple(kept) if len(kept) > 1
                       else (kept[0] if kept else None))
    return tuple(entries)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dimension:
    ``Shard(d)`` where tensor dim ``d`` names the axis, else
    ``Replicate()``. A dim cut over several axes is cut over the first
    named, then each piece over the next: JAX's major-to-minor order,
    which DTensor gives only when the axes come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


_DTENSOR = None          # DTensor's class, imported at the first ask


def _is_dtensor(x) -> bool:
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


class _Constrain(torch.autograd.Function):
    """A redistribute whose gradient is redistributed to the same
    placements: JAX's sharding constraint holds the cotangent too, where
    DTensor's own backward would hand back the input's layout (a
    replicated loss gradient would then stay replicated, whole batches on
    every rank)."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.want), None


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Constrain an intermediate, and its gradient, to its logical
    sharding: a redistribute inside :func:`sharding_ctx` (uneven shards
    allowed, as in JAX), a no-op outside it or on a tensor that is not a
    DTensor."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or not _is_dtensor(x) or x.ndim != len(logical):
        return x
    spec = spec_for(x.shape, logical, mesh, rules, allow_uneven=True)
    # a dim of one, cut, leaves every rank but one with nothing, which
    # DTensor's products refuse; rank 0 holds all of it either way
    want = placements(tuple(None if n == 1 else e
                            for n, e in zip(x.shape, spec)), mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                     want)
    return _Constrain.apply(x, want)


def unshard(tree, logical: str = "fsdp"):
    """``tree`` (a tensor or nested dicts of them) with every DTensor leaf
    gathered over the mesh axes of the ``logical`` rule: ZeRO-3's gather of
    a layer's weights where it runs, which GSPMD inserts and DTensor does
    not (its product rule would rather cut the activations along the
    weight's sharded contraction dim and compute full-batch partial sums
    on every rank). A no-op outside :func:`sharding_ctx`."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return tree
    if isinstance(tree, dict):
        return {k: unshard(v, logical) for k, v in tree.items()}
    if not _is_dtensor(tree):
        return tree
    from torch.distributed.tensor import Replicate
    rule = rules.get(logical) or ()
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    want = tuple(Replicate() if name in axes else p for name, p in
                 zip(tree.device_mesh.mesh_dim_names, tree.placements))
    if want == tuple(tree.placements):
        return tree
    return tree.redistribute(tree.device_mesh, want)


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``. On a DTensor whose mesh axes on
    ``dim`` do not divide ``sizes[0]`` (a shard would hold part of a
    head), ``dim`` is gathered first: DTensor cannot view it, GSPMD
    gathers it silently."""
    if _is_dtensor(x):
        dim = dim % x.ndim
        if sizes[0] % _ways(x, dim):
            return _viewed(x, [dim], lambda t: t.unflatten(dim, sizes))
    return x.unflatten(dim, sizes)


def flatten(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)``. On a DTensor, the dims it merges are
    gathered first where DTensor cannot view them cut: ``start`` cut
    unevenly (its mesh axes do not divide it: Arctic's 56 query heads on
    TP = 16; GSPMD pads), and any later dim cut at all (the MoE's tokens,
    (B, S) with the sequence cut over "model": torch 2.11 refuses, and
    XLA's HLO gathers S there)."""
    if _is_dtensor(x):
        start, end = start % x.ndim, end % x.ndim
        cut = [d for d in range(start + 1, end + 1) if _ways(x, d) > 1]
        if x.shape[start] % _ways(x, start):
            cut.insert(0, start)
        if cut:
            return _viewed(x, cut, lambda t: t.flatten(start, end))
    return x.flatten(start, end)


def _ways(x: torch.Tensor, dim: int) -> int:
    """How many pieces the mesh axes cut DTensor ``x``'s dim ``dim`` into."""
    from torch.distributed.tensor import Shard
    return math.prod(m for m, p in zip(x.device_mesh.shape, x.placements)
                     if p == Shard(dim))


class _Hold(_Constrain):
    """A view's output, whose cotangent is laid out as the output before
    the view's backward, which would otherwise meet it cut as the layers
    downstream cut it, and in one dense piece a rank: gathering an uneven
    cut can hand back a strided slice of the padded buffer (torch 2.11),
    which the view's backward cannot view."""

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        g = g.redistribute(g.device_mesh, ctx.want)
        local = g.to_local()
        if not local.is_contiguous():
            g = DTensor.from_local(local.contiguous(), g.device_mesh,
                                   g.placements, run_check=False,
                                   shape=g.shape, stride=g.stride())
        return g, None


def _viewed(x: torch.Tensor, dims: Sequence[int], view) -> torch.Tensor:
    """``view(x)`` with ``dims`` gathered first (:class:`_Hold` keeps its
    cotangent viewable)."""
    from torch.distributed.tensor import Replicate, Shard
    y = view(x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim in dims else p
        for p in x.placements]))
    return _Hold.apply(y, tuple(y.placements)) if y.requires_grad else y


def align(x: torch.Tensor, ref: torch.Tensor, dim: int,
          ref_dim: Optional[int] = None) -> torch.Tensor:
    """``x`` with its dim ``dim`` cut over the mesh axes that cut ``ref``'s
    dim ``ref_dim`` (default ``dim``), and over no other: the two sides of
    a product alike, where GSPMD reshards the other side silently and
    DTensor refuses. A no-op unless both are DTensors."""
    if not (_is_dtensor(x) and _is_dtensor(ref)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    d, rd = Shard(dim % x.ndim), Shard((dim if ref_dim is None
                                        else ref_dim) % ref.ndim)
    want = tuple(d if rp == rd else (Replicate() if xp == d else xp)
                 for xp, rp in zip(x.placements, ref.placements))
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (a weight ``w`` of two dims) as GSPMD partitions it, on
    each rank's local tensors:

    * where a row dim of ``x`` is cut over a mesh axis that also cuts
      ``w`` (the sequence cut over "model" against the "tp" columns or
      rows), ``w`` is gathered over that axis and ``x`` keeps its cut:
      GSPMD's choice on the smoke cells (XLA's HLO gathers ``wq``, ``wi``,
      ``wo`` and ``wdown`` whole over "model" and runs every product on
      the rank's own tokens), where DTensor's product refuses the layout
      (torch 2.11 flattens (B, S) with S cut);
    * a contraction cut over a mesh axis gives a partial sum, all-reduced
      at the product as GSPMD does; left partial, DTensor reduces it later
      onto a cut dim and gathers it again;
    * ``w``'s cut columns stay cut, and ``x`` is gathered where its last
      dim is cut over the same axis (the mLSTM's ``xin`` before ``wqkv``,
      as XLA's HLO gathers it);
    * a partial ``x`` (the decode's attention output, summed over the
      cache's cut slots) is all-reduced first, as GSPMD does, not
      reduce-scattered onto the contraction.

    Each local tensor's gradient is declared as the local product makes
    it: partial where this rank summed only its own rows or columns.
    On plain tensors, ``x @ w``."""
    if not (_is_dtensor(x) and _is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last, whole = x.device_mesh, x.ndim - 1, Replicate()
    if any(isinstance(p, Partial) for p in x.placements):
        x = x.redistribute(mesh, [whole if isinstance(p, Partial) else p
                                  for p in x.placements])
    # a mesh dim's placements of x, w and y, then of x's and w's gradients
    plan = []
    for px, pw in zip(x.placements, w.placements):
        sx = px.dim % x.ndim if isinstance(px, Shard) else None
        sw = pw.dim % 2 if isinstance(pw, Shard) else None
        if sx is not None and sx < last:           # x's rows: w whole
            plan.append((px, whole, px, px, Partial()))
        elif sw == 1:                              # w's columns: x whole
            plan.append((whole, pw, Shard(last), Partial(), pw))
        elif sx == last or sw == 0:                # the contraction: partial
            cut = (Shard(last), Shard(0))
            plan.append(cut + (Partial(),) + cut)
        else:
            plan.append((whole,) * 5)
    xp, wp, yp, xg, wg = zip(*plan)
    if tuple(xp) != tuple(x.placements):
        x = x.redistribute(mesh, xp)
    if tuple(wp) != tuple(w.placements):
        w = w.redistribute(mesh, wp)
    shape = x.shape[:-1] + w.shape[-1:]
    y = DTensor.from_local(
        x.to_local(grad_placements=xg) @ w.to_local(grad_placements=wg),
        mesh, yp, run_check=False, shape=shape,
        stride=_contiguous_stride(shape))
    if any(isinstance(p, Partial) for p in yp):
        y = y.redistribute(mesh, [whole if isinstance(p, Partial) else p
                                  for p in yp])
    return y


def _contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


class _Relayout(torch.autograd.Function):
    """One all-to-all over a mesh ``group`` that moves pieces of dim 0 of
    the local tensors: this rank sends its rows in ``order`` (None: as
    they are), ``split_in`` to each rank in turn, and receives
    ``split_out`` from each; the backward sends every piece back."""

    @staticmethod
    def forward(ctx, t, group, order, split_in, split_out):
        from torch.distributed import _functional_collectives as fc
        ctx.group, ctx.order, ctx.splits = group, order, (split_in,
                                                          split_out)
        if order is not None:
            t = t[order]
        return fc.wait_tensor(fc.all_to_all_single(
            t.contiguous(), split_out, split_in, group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as fc
        split_in, split_out = ctx.splits
        back = fc.wait_tensor(fc.all_to_all_single(
            g.contiguous(), split_in, split_out, ctx.group))
        if ctx.order is not None:
            out = torch.empty_like(back)
            out[ctx.order] = back
            back = out
        return back, None, None, None, None


def chunk(x: torch.Tensor, parts: int, dim: int = -1):
    """``x.chunk(parts, dim)``. On a DTensor whose ``dim`` is cut evenly
    over one mesh dim (of n ranks, each chunk a multiple of n), each chunk
    comes out cut over that mesh dim as ``x`` was, the pieces moved in
    place by one all-to-all of the local shard, as GSPMD moves them
    (collective-permutes in XLA's HLO: swiglu's gate/up split, the
    mLSTM's up/z split); DTensor itself would gather the whole dim."""
    if not _is_dtensor(x):
        return x.chunk(parts, dim)
    from torch.distributed.tensor import DTensor, Shard
    dim = dim % x.ndim
    cut = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    size = x.shape[dim]
    if len(cut) != 1 or size % parts:
        return x.chunk(parts, dim)
    md, = cut
    mesh = x.device_mesh
    n = mesh.shape[md]
    if n == 1 or (size // parts) % n:
        return x.chunk(parts, dim)
    r = mesh.get_coordinate()[md]
    piece = size // parts // n                     # rows of one piece
    # this rank holds global pieces r*parts + j; piece p goes to rank
    # p % n as that rank's piece of chunk p // n
    dest = [(r * parts + j) % n for j in range(parts)]
    js = sorted(range(parts), key=lambda j: dest[j])
    order = None if js == sorted(js) else torch.cat([
        torch.arange(j * piece, (j + 1) * piece, device=x.to_local().device)
        for j in js])
    split_in = [dest.count(d) * piece for d in range(n)]
    split_out = [sum((c * n + r) // parts == s for c in range(parts)) * piece
                 for s in range(n)]
    local = x.to_local().movedim(dim, 0)
    out = _Relayout.apply(local, (mesh, md), order, split_in, split_out)
    shape = x.shape[:dim] + (size // parts,) + x.shape[dim + 1:]
    return tuple(DTensor.from_local(
        out[c * piece:(c + 1) * piece].movedim(0, dim), mesh, x.placements,
        run_check=False, shape=shape, stride=_contiguous_stride(shape))
        for c in range(parts))


def pieces(x: torch.Tensor, n: int, logical: str) -> int:
    """How many ranks share each of ``n`` items (heads) of DTensor ``x``
    that the ``logical`` rule cuts over one mesh axis with more ranks than
    items: its ranks over ``n`` where ``n`` divides them, else 1 (and 1
    outside :func:`sharding_ctx` or on a plain tensor)."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or not _is_dtensor(x):
        return 1
    rule = rules.get(logical)
    axes = (rule,) if isinstance(rule, str) else tuple(rule or ())
    ranks = mesh_shape(mesh).get(axes[0], 1) if len(axes) == 1 else 1
    return ranks // n if ranks > n and ranks % n == 0 else 1


def parts_group(x: torch.Tensor, dim: int, k: int):
    """(the process group of this rank and the others that share its
    piece, the whole mesh dim): DTensor ``x``'s dim ``dim`` is cut over
    one mesh dim, seen here as groups of ``k`` consecutive ranks (the
    ranks that split one mLSTM head's P). Each group is made once a mesh:
    every rank makes every group, in the same order."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    md = next(i for i, p in enumerate(x.placements) if p == Shard(dim))
    groups = mesh.__dict__.setdefault("_parts_groups", {})
    if (md, k) not in groups:
        import numpy as np
        import torch.distributed as dist
        # init_device_mesh's layout (the ranks in order, mesh dims major to
        # minor), checked against this rank's own line
        line = np.moveaxis(np.arange(math.prod(mesh.shape)).reshape(
            tuple(mesh.shape)), md, -1).reshape(-1, mesh.shape[md])
        mine = dist.get_process_group_ranks(mesh.get_group(md))
        if mine not in line.tolist():
            raise ValueError("a mesh whose ranks are not in order")
        ranks = line.reshape(-1, k).tolist()
        groups[(md, k)] = dist.new_subgroups_by_enumeration(ranks)[0]
    return groups[(md, k)], (mesh, md)


class _GroupSum(torch.autograd.Function):
    """Partial sums summed over ``group`` (an all-reduce); each rank's
    gradient is its share of the downstream work, summed the same way."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as fc
        ctx.group = group
        return fc.wait_tensor(fc.all_reduce(t.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as fc
        return fc.wait_tensor(fc.all_reduce(g.contiguous(), "sum",
                                            ctx.group)), None


class _GroupGather(torch.autograd.Function):
    """Each rank's piece of dim ``dim`` gathered over ``group`` (an
    all-gather, in rank order); the gradient reduce-scattered back."""

    @staticmethod
    def forward(ctx, t, dim, group):
        from torch.distributed import _functional_collectives as fc
        ctx.dim, ctx.group = dim, group
        return fc.wait_tensor(fc.all_gather_tensor(t.contiguous(), dim,
                                                   group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as fc
        return fc.wait_tensor(fc.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``; ``t`` itself without one."""
    return t if group is None else _GroupSum.apply(t, group)


def group_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t``'s pieces along ``dim`` gathered over ``group`` in rank order;
    ``t`` itself without one."""
    return t if group is None else _GroupGather.apply(t, dim % t.ndim, group)


def _local_range(n: int, dim: int, mesh, placed) -> Tuple[int, int]:
    """(start, length) of this rank's piece of a dim of ``n`` that
    ``placed`` cuts: DTensor's ceil-sized chunks, over each mesh dim that
    cuts ``dim`` in mesh order (the last ranks may hold fewer, or none)."""
    from torch.distributed.tensor import Shard
    off = 0
    for size, c, p in zip(mesh.shape, mesh.get_coordinate(), placed):
        if p == Shard(dim):
            step = -(-n // size)
            lo = min(c * step, n)
            off, n = off + lo, min(lo + step, n) - lo
    return off, n


def per_shard(fn, ref: torch.Tensor, *args: torch.Tensor,
              dims: Sequence[int], shape, arg_dims=None, out_dims=None,
              offsets: bool = False, **kw):
    """``fn(ref, *args, **kw)``. On a DTensor, shard by shard: ``ref`` is
    kept cut on ``dims`` only (a dim cut elsewhere is gathered), and ``fn``
    runs on the local tensors. Each of ``args`` says how it is cut in
    ``arg_dims``, one tuple an arg aligned with ``dims``: its dim cut as
    ``ref``'s ``dims[i]``, or None where it is whole (the Mamba ``B``/``C``
    have no head dim; K and V are whole over the query heads); by default
    each is cut as ``ref``. Each tensor of ``kw`` is whole on every rank.
    The result (a tensor of global ``shape``, or a tuple of them and a
    tuple of shapes) is cut as ``out_dims`` says (default: as ``ref``);
    ``"sum"`` in place of a dim makes it a partial sum over the mesh dims
    that cut ``dims[i]`` (each rank's share of a masked gather).
    A tensor whole over a mesh dim that cuts the work gets its gradient
    summed over it. With ``offsets``, ``fn`` also gets ``offsets=``: this
    rank's start along each of ``dims`` (0 off a mesh).

    For work independent along ``dims``, such as the attention core over
    the batch and the query heads or a scan over the batch and its heads,
    where DTensor's batched product refuses two cut dims merged into one
    and cannot view a cut head dim as (KV head, group) (GSPMD tiles
    both)."""
    if offsets:
        kw["offsets"] = (0,) * len(dims)
    if not _is_dtensor(ref):
        return fn(ref, *args, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ref.device_mesh
    dims = tuple(dims)
    # which of ``dims`` each mesh dim cuts (None: it cuts no work)
    cuts = [dims.index(p.dim) if isinstance(p, Shard) and p.dim in dims
            else None for p in ref.placements]
    whole = (None,) * len(dims)

    def placed(at):             # a tensor whose dims[i] is its dim at[i]
        return tuple(Replicate() if i is None or at[i] is None
                     else Partial() if at[i] == "sum" else Shard(at[i])
                     for i in cuts)

    def summed(at):             # its gradient: whole where work is cut
        return tuple(Partial() if i is not None and at[i] is None else p
                     for i, p in zip(cuts, placed(at)))

    def local(a, at):           # a plain tensor is whole everywhere
        if not _is_dtensor(a):
            a = DTensor.from_local(a, mesh, placed(whole), run_check=False)
        return a.redistribute(mesh, placed(at)).to_local(
            grad_placements=summed(at))
    want = placed(dims)
    if offsets:
        kw["offsets"] = tuple(_local_range(ref.shape[d], d, mesh, want)[0]
                              for d in dims)
    kw = {k: local(v, whole) if isinstance(v, torch.Tensor) else v
          for k, v in kw.items()}
    arg_dims = arg_dims or (dims,) * len(args)
    out = fn(local(ref, dims), *map(local, args, arg_dims), **kw)

    def wrap(t, shp, at):
        return DTensor.from_local(t.contiguous(), mesh, placed(at),
                                  run_check=False, shape=torch.Size(shp),
                                  stride=_contiguous_stride(shp))
    if isinstance(out, tuple):
        return tuple(map(wrap, out, shape, out_dims or (dims,) * len(out)))
    return wrap(out, shape, out_dims or dims)


def take_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index[..., None])[..., 0]``. On a DTensor,
    on each rank's local tensors, ``index`` cut as ``x``'s other dims: a
    gather (and its gradient, a scatter) on every rank's own rows, where
    DTensor's gather rule replicates both (the sequence cut over "model":
    the whole batch's logits gradient on every rank). Where ``x``'s last
    dim is cut too, each shard picks the indices it holds (zero elsewhere)
    and a sum over those mesh axes gives the rest: JAX's masked sum, one
    small all-reduce and the last dim never gathered."""
    if not _is_dtensor(x):
        return torch.gather(x, -1, index.long()[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    last = Shard(x.ndim - 1)
    mesh = x.device_mesh
    off, n = _local_range(x.shape[-1], x.ndim - 1, mesh, x.placements)
    idx = index.redistribute(mesh, [Replicate() if p == last else p
                                    for p in x.placements])
    i = idx.to_local().long() - off
    got = torch.gather(x.to_local(), -1,
                       i.clamp(0, max(n - 1, 0))[..., None])[..., 0]
    if last in x.placements:
        got = torch.where((i >= 0) & (i < n), got, 0.0)
    shape = x.shape[:-1]
    return DTensor.from_local(
        got, mesh, [Partial() if p == last else p for p in x.placements],
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


class _TakeRows(torch.autograd.Function):
    """The rows of local ``table`` (this rank's vocab rows from ``off``,
    its own columns) that the ids of every rank of ``group`` (a mesh dim
    of ``n`` ranks, this one ``r``) pick, zero where a row lies on another
    rank; each rank's block of them sent to it by one all-to-all (this
    rank's own kept), so each rank ends with its own ids' rows, ``n``
    column pieces side by side. The backward sends each piece's gradient
    back and scatter-adds it into the local rows: the rank's own rows and
    columns, never the whole table."""

    @staticmethod
    def forward(ctx, table, ids, off, group, n, r):
        from torch.distributed import _functional_collectives as fc
        every = fc.wait_tensor(fc.all_gather_tensor(ids, 0, group)) \
            if n > 1 else ids
        i = every.long() - off
        hit = ((i >= 0) & (i < table.shape[0]))[:, None]
        i = i.clamp(0, max(table.shape[0] - 1, 0))
        rows = torch.where(hit, F.embedding(i, table), 0.0)
        ctx.save_for_backward(i, hit)
        ctx.args = (table.shape, group, n, r)
        return _TakeRows._swap(rows.chunk(n), group, n, r, 1)

    @staticmethod
    def backward(ctx, g):
        i, hit = ctx.saved_tensors
        shape, group, n, r = ctx.args
        g = _TakeRows._swap(g.chunk(n, dim=1), group, n, r, 0)
        return (torch.zeros(shape, dtype=g.dtype, device=g.device)
                .index_add_(0, i, torch.where(hit, g, 0.0)),
                None, None, None, None, None)

    @staticmethod
    def _swap(pieces, group, n, r, dim):
        """``pieces[j]`` to rank ``j`` (one all-to-all of the others),
        what each rank ``j`` sent in its place, joined along ``dim``."""
        if n == 1:
            return pieces[0].contiguous()
        from torch.distributed import _functional_collectives as fc
        send = torch.cat([p for j, p in enumerate(pieces) if j != r])
        split = [0 if j == r else pieces[j].shape[0] for j in range(n)]
        got = fc.wait_tensor(fc.all_to_all_single(send.contiguous(), split,
                                                  split, group))
        got = list(got.split([s for j, s in enumerate(split) if j != r]))
        got.insert(r, pieces[r])
        return torch.cat(got, dim=dim)


def take_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``. On a DTensor table inside
    :func:`sharding_ctx` whose columns one mesh dim cuts (the "fsdp" rule)
    and whose ids that dim cuts too (the batch), the lookup is XLA's: the
    ids gathered over that dim, each rank's own rows picked on its own
    columns (shifted by its vocab offset, zero elsewhere, as
    :func:`take_last` masks), the pieces sent back to the ranks whose ids
    they are by one all-to-all, and the rows' partial sums left to the
    caller's :func:`shard` (one all-reduce over the vocab's axes); the
    gradient scatter-adds into each rank's own rows and columns. It is
    taken where it moves fewer bytes (as the dry run counts a collective:
    its operand) than gathering the table's columns (:func:`unshard`, and
    a reduce-scatter of at least the gathered table in the backward),
    which stays the lookup elsewhere: where few ids meet a large table (a
    decode step), and not where many do (``train_4k``, ``prefill_32k``)."""
    if _CTX.mesh is None or not _is_dtensor(table):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, tp = table.device_mesh, table.placements
    kp = (tokens.placements if _is_dtensor(tokens)
          else (Replicate(),) * len(tp))
    cols = [d for d, p in enumerate(tp) if p == Shard(1)]
    md = cols[0] if len(cols) == 1 else None
    if (md is None or not isinstance(kp[md], Shard)
            or tokens.shape[kp[md].dim] % _ways(tokens, kp[md].dim)
            or table.shape[1] % mesh.shape[md]
            or any(p == Shard(0) and q != Replicate()
                   for p, q in zip(tp, kp))):
        return F.embedding(tokens, unshard(table))
    n, ids = mesh.shape[md], tokens.to_local()
    off, vl = _local_range(table.shape[0], 0, mesh, tp)
    if n > 1:
        L, c, b = ids.numel(), table.shape[1] // n, table.element_size()
        grad = table.requires_grad and torch.is_grad_enabled()
        if L * ids.element_size() + (n - 1) * L * c * b * (1 + grad) >= \
                vl * c * b * (1 + n * grad):
            return F.embedding(tokens, unshard(table))
    # the table's gradient: its own shard, summed where the ids are cut
    # and the table is whole (the batch over "pod")
    held = [Partial() if p == Replicate() and q != Replicate() else p
            for p, q in zip(tp, kp)]
    got = _TakeRows.apply(table.to_local(grad_placements=held),
                          ids.reshape(-1).contiguous(), off, (mesh, md), n,
                          mesh.get_coordinate()[md])
    shape = tokens.shape + table.shape[1:]
    return DTensor.from_local(
        got.reshape(ids.shape + table.shape[1:]), mesh,
        [Partial() if p == Shard(0) else q for p, q in zip(tp, kp)],
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


def put_prefix(buf: torch.Tensor, i: int, value: torch.Tensor) -> None:
    """``buf[i, :, :n] = value`` in place, ``n = value.shape[1]``: a
    layer's prompt K or V into its cache. On a DTensor whose dim 2 (the
    cache's slots) is cut, DTensor writes a slice of that dim into a
    gathered copy and drops the write; so the row ``buf[i]`` is rebuilt
    whole (``value``, then the row's own slots from ``n``), laid out as
    the row is, and written along the uncut dim 0."""
    n = value.shape[1]
    if not _is_dtensor(buf):
        buf[i, :, :n] = value
        return
    row = buf[i]
    new = torch.cat([value.to(row.dtype), row[:, n:]], dim=1)
    buf[i] = new.redistribute(row.device_mesh, row.placements)


def full(shape: Sequence[int], fill_value: float, dtype: torch.dtype,
         device, *logical: Optional[str]) -> torch.Tensor:
    """``torch.full``; inside :func:`sharding_ctx`, a DTensor laid out as
    ``logical`` (argument-grade, as :func:`named`), each shard made on its
    own: a buffer a model fills in place or carries through a loop (the
    prefill's KV cache, the online softmax's running statistics), which
    JAX's GSPMD lays out by propagation."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None:
        return torch.full(tuple(shape), fill_value, dtype=dtype,
                          device=device)
    from torch.distributed import tensor as dt
    return dt.full(tuple(shape), fill_value, dtype=dtype, device_mesh=mesh,
                   placements=placements(
                       spec_for(shape, logical, mesh, rules), mesh))


def named(mesh, rules: Dict[str, AxisRule], shape: Sequence[int],
          *logical: Optional[str]) -> NamedSharding:
    """Argument-grade sharding (strict divisibility)."""
    spec = spec_for(shape, logical, mesh, rules)
    return NamedSharding(mesh, spec, placements(spec, mesh))


def batch_sharding(mesh, shape: Sequence[int],
                   rules: Optional[Dict[str, AxisRule]] = None
                   ) -> NamedSharding:
    """Argument sharding for a batch-leading tensor via the "batch"
    rule: one replica's micro-batch on each shard of the "data" axis;
    non-batch dims stay unsharded, and a batch the data axis does not
    divide falls back to replicated (``spec_for`` auto-drop)."""
    logical = ("batch",) + (None,) * (len(shape) - 1)
    return named(mesh, rules or DEFAULT_RULES, shape, *logical)


# ---------------------------------------------------------------------------
# Parameter shardings: leaf-name -> logical axes per dimension
# ---------------------------------------------------------------------------

# Matched against the *last* key of the tree path. A leading "layers" axis
# (stacked blocks) is detected by rank mismatch and left unsharded.
_PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings / head
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "frontend_proj": ("fsdp", "tp"),
    # attention (flat head dims)
    "wq": ("fsdp", "tp"),
    "wk": ("fsdp", "tp"),
    "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # dense mlp
    "wi": ("fsdp", "tp"),
    "wdown": ("tp", "fsdp"),
    # MoE
    "router": (None, None),
    "moe_wi": ("experts", "fsdp", "tp"),
    "moe_wdown": ("experts", "tp", "fsdp"),
    # mamba2
    "in_proj": ("fsdp", "tp"),
    "out_proj": ("tp", "fsdp"),
    "conv_w": (None, "tp"),
    # xlstm
    "wqkv": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_gates": ("fsdp", "tp"),
    "r_gates": (None, "tp"),
}


def param_spec(path: Sequence[str], leaf) -> Tuple[Optional[str], ...]:
    """Logical axes for one parameter leaf; ``path`` is the leaf's key
    tuple (``lm.tree_leaves``)."""
    key = next((k for k in reversed(path) if isinstance(k, str)), None)
    axes = _PARAM_AXES.get(key)
    if axes is None:
        return (None,) * leaf.ndim               # norms, biases, scalars
    if leaf.ndim == len(axes) + 1:               # stacked: leading L axis
        return ("layers",) + axes
    if leaf.ndim != len(axes):
        return (None,) * leaf.ndim
    return axes


def param_shardings(mesh, rules: Dict[str, AxisRule], params):
    """A :class:`NamedSharding` for every leaf of a parameter tree (nested
    dicts of tensors, or of anything with ``shape`` and ``ndim``), in its
    tree."""
    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else named(mesh, rules, v.shape, *param_spec(path + (k,), v))
                for k, v in tree.items()}
    return walk(params, ())
