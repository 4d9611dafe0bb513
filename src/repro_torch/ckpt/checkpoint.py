"""Resumable training checkpoints: a copy of the JAX package's
``ckpt/checkpoint.py``, in its layout.

Layout:  <dir>/step_<N>/
            manifest.json        - treedef, shapes, dtypes, step
            leaf_<i>.npy         - one array per tree leaf
            _COMMITTED           - written last; partial checkpoints are
                                   ignored on restore (crash safety)

Leaves are numbered in JAX's flatten order (dict keys sorted, a
NamedTuple's fields in order, ``TrainState(params, AdamWState(step, m,
v))``), which is not ``lm.tree_leaves``'s insertion order, and the
manifest's ``treedef`` is JAX's string for the same tree: a checkpoint
either package writes in fp32 loads in the other. A bf16 leaf is written
as its raw 2-byte bits under the ``<V2`` header ``np.save`` gives an
``ml_dtypes`` bfloat16 array, with ``"bfloat16"`` in the manifest, and
read back by the manifest (the port never imports ``ml_dtypes``).

* Async: :class:`CheckpointManager` copies the tree to the host, then
  writes it on a background thread, so the loop never waits on the disk.
* Fault-tolerant: :func:`latest_step` scans for the newest committed step
  and removes stale ``.tmp`` wreckage a crashed writer left behind.

:func:`commit_dir` is the atomic-commit primitive (write into
``<target>.tmp``, stamp ``_COMMITTED``, rename); the serving artifact
(:mod:`repro_torch.pipeline.artifact`) is committed under it too, with
the same leaf files.
"""
from __future__ import annotations

import atexit
import json
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# the bytes np.save writes before a bfloat16 leaf's data
BF16_DESCR = "<V2"

Leaf = Tuple[np.ndarray, str]           # (host array, manifest dtype)


class CheckpointError(ValueError):
    """A checkpoint or artifact on disk does not match what its reader
    expects: uncommitted, truncated or corrupt leaves, wrong leaf count,
    shapes or dtypes."""


def commit_dir(target: Path, write: Callable[[Path], None]) -> Path:
    """Atomically materialise ``target``: ``write(tmp)`` fills a
    ``<target>.tmp`` staging directory, then ``_COMMITTED`` is stamped and
    the directory renamed into place."""
    target = Path(target)
    tmp = Path(str(target) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    write(tmp)
    (tmp / "_COMMITTED").write_text("ok")
    if target.exists():
        shutil.rmtree(target)
    tmp.rename(target)
    return target


def clean_stale_tmp(ckpt_dir: str) -> int:
    """Remove the ``*.tmp`` staging directories under ``ckpt_dir`` (a
    crashed writer's wreckage, never read). Returns how many went."""
    root = Path(ckpt_dir)
    if not root.exists():
        return 0
    stale = [d for d in root.iterdir()
             if d.is_dir() and d.name.endswith(".tmp")]
    for d in stale:
        shutil.rmtree(d, ignore_errors=True)
    return len(stale)


# -- leaves <-> files ---------------------------------------------------------

def host_leaf(t: torch.Tensor) -> Leaf:
    """A copy of the tensor on the host as (numpy array, manifest dtype);
    bf16 as its raw bits. A copy even of a CPU tensor: an async save
    writes it after the caller has gone on."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_leaf(path: Path, leaf: Leaf) -> None:
    a, dtype = leaf
    if dtype != "bfloat16":
        np.save(path, a)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": a.shape})
        f.write(a.tobytes())


def leaf_tensor(a: np.ndarray, dtype: str) -> Optional[torch.Tensor]:
    """The tensor a loaded leaf holds, read by its manifest ``dtype``: a
    2-byte void or integer array called bfloat16 is bf16 bits. None where
    the array is neither that nor ``dtype``."""
    if (dtype == "bfloat16" and a.dtype.itemsize == 2
            and a.dtype.kind in "Vui"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if str(a.dtype) != dtype:
        return None
    return torch.from_numpy(a)


# -- JAX's flatten order -----------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree) -> Tuple[list, str]:
    """(leaves, treedef) in JAX's order: dict keys sorted, NamedTuple
    fields and list/tuple items in order; the treedef is the string
    ``str(jax.tree_util.tree_structure)`` gives the same tree."""
    leaves: list = []

    def walk(x) -> str:
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], ["
                    + ", ".join(walk(c) for c in x) + "])")
        if isinstance(x, list):
            return "[" + ", ".join(walk(c) for c in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(walk(c) for c in x)
            return "(" + inner + ("," if len(x) == 1 else "") + ")"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure with ``leaves`` (in :func:`tree_flatten`'s
    order) in place of its leaves."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}        # keep like's key order
        if _is_namedtuple(x):
            return type(x)(*(build(c) for c in x))
        if isinstance(x, (list, tuple)):
            return type(x)(build(c) for c in x)
        return next(it)

    return build(like)


# -- checkpoints ---------------------------------------------------------------

def _write(ckpt_dir: str, step: int, leaves: List[Leaf],
           treedef: str) -> Path:
    def write(tmp: Path) -> None:
        manifest = {"step": step, "treedef": treedef,
                    "n_leaves": len(leaves),
                    "leaves": [{"shape": list(a.shape), "dtype": dt}
                               for a, dt in leaves]}
        for i, leaf in enumerate(leaves):
            save_leaf(tmp / f"leaf_{i}.npy", leaf)
        (tmp / "manifest.json").write_text(
            json.dumps(manifest, sort_keys=True))

    return commit_dir(Path(ckpt_dir) / f"step_{step:08d}", write)


def _host_tree(tree) -> Tuple[List[Leaf], str]:
    leaves, treedef = tree_flatten(tree)
    return [host_leaf(t) for t in leaves], treedef


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> Path:
    """Write one committed checkpoint synchronously."""
    return _write(ckpt_dir, step, *_host_tree(tree))


def committed_steps(ckpt_dir: str) -> List[int]:
    """The committed steps under ``ckpt_dir``, in order."""
    root = Path(ckpt_dir)
    if not root.exists():
        return []
    return sorted(int(d.name.split("_")[1]) for d in root.iterdir()
                  if d.name.startswith("step_")
                  and (d / "_COMMITTED").exists())


def latest_step(ckpt_dir: str) -> Optional[int]:
    clean_stale_tmp(ckpt_dir)
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                    shardings: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` -> (tree, step).

    ``like`` supplies the structure and each leaf's dtype and device (its
    values are ignored); a leaf is cast to its ``like`` leaf's dtype, as
    in JAX. ``shardings`` (optional) is a tree of the same structure whose
    leaves are ``parallel.sharding.NamedSharding``s (a mesh and its
    placements; ``param_shardings`` builds one for parameters): each leaf
    is loaded whole and placed with ``distribute_tensor`` on the mesh's
    device type, JAX's ``device_put`` under a ``NamedSharding``. The
    mesh's process group must be running.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    root = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((root / "manifest.json").read_text())
    refs, _ = tree_flatten(like)
    places = [None] * len(refs)
    if shardings is not None:
        places, _ = tree_flatten(shardings)
        if len(places) != len(refs):
            raise ValueError(f"load_checkpoint: {len(places)} shardings for "
                             f"{len(refs)} leaves")
        bad = [type(p).__name__ for p in places
               if not (hasattr(p, "mesh") and hasattr(p, "placements"))]
        if bad:
            raise ValueError(f"load_checkpoint: shardings leaves must be "
                             f"NamedShardings, not {sorted(set(bad))}")
    if manifest["n_leaves"] != len(refs):
        raise CheckpointError(
            f"checkpoint {root} (step {step}) has "
            f"{manifest['n_leaves']} leaves but the model expects "
            f"{len(refs)} — restoring into a different architecture?")
    loaded = []
    for i, (ref, meta, place) in enumerate(zip(refs, manifest["leaves"],
                                               places)):
        try:
            a = np.load(root / f"leaf_{i}.npy")
        except Exception as e:          # truncated/corrupt/missing array
            raise CheckpointError(
                f"checkpoint {root} (step {step}): leaf {i} "
                f"(leaf_{i}.npy) is unreadable — truncated or corrupt "
                f"write? ({type(e).__name__}: {e})") from e
        got = leaf_tensor(a, meta["dtype"])
        if got is None:
            raise CheckpointError(
                f"checkpoint {root} (step {step}): leaf {i} is {a.dtype} "
                f"but the manifest says {meta['dtype']}")
        if tuple(got.shape) != tuple(ref.shape):
            raise CheckpointError(
                f"checkpoint {root} (step {step}): leaf {i} has shape "
                f"{tuple(got.shape)} but the model expects "
                f"{tuple(ref.shape)}")
        if place is None:
            loaded.append(got.to(device=ref.device, dtype=ref.dtype))
            continue
        from torch.distributed.tensor import distribute_tensor
        loaded.append(distribute_tensor(
            got.to(device=place.mesh.device_type, dtype=ref.dtype),
            place.mesh, place.placements))
    return tree_unflatten(like, loaded), step


class CheckpointManager:
    """Async checkpointing with bounded retention.

    Construction removes stale ``.tmp`` staging directories (crashed
    writers) and registers an ``atexit`` flush: if the process exits with
    the last ``save_async`` still in flight, or failed, the error
    surfaces instead of being dropped with the daemon thread.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        clean_stale_tmp(ckpt_dir)
        atexit.register(self._flush_at_exit)

    def _flush_at_exit(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:     # atexit prints the traceback
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   first: Optional[Tuple[str, Any]] = None) -> None:
        """Copy ``tree`` to the host now (the caller may then change it in
        place), and write it on a background thread.

        ``first``, a ``(ckpt_dir, tree)`` pair, is copied now too, and the
        same thread commits it at ``step`` (and prunes its directory to
        ``keep``) before it writes ``tree``: whoever finds ``tree``'s step
        committed finds ``first``'s too.
        """
        self.wait()
        jobs = [] if first is None else [(first[0], *_host_tree(first[1]))]
        jobs.append((self.dir, *_host_tree(tree)))

        def work():
            try:
                for d, leaves, treedef in jobs:
                    _write(d, step, leaves, treedef)
                    _prune(d, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _prune(ckpt_dir: str, keep: int) -> None:
    """Remove all but the newest ``keep`` committed steps."""
    for s in committed_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(Path(ckpt_dir) / f"step_{s:08d}", ignore_errors=True)
