"""Production mesh construction: the JAX package's ``launch/mesh.py`` over
torch's ``DeviceMesh``.

JAX forces 256 or 512 host devices; the port stands up the same meshes
over the ``fake`` process group, whose collectives move nothing: the dry
run (:mod:`repro_torch.launch.dryrun`) traces one rank of them. A
process holds one default group, so :func:`make_mesh` starts it (or
checks that the running one has the mesh's size): a new world size needs
a new process, or :func:`teardown` first. The ``fake`` backend is
registered only once ``torch.testing._internal.distributed.fake_pg`` is
imported, which :func:`make_mesh` does.

JAX's ``compat_make_mesh`` shim for ``jax.sharding.AxisType`` has no
counterpart: :func:`make_mesh` is its twin without it.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

from repro_torch.parallel.sharding import AxisRule

__all__ = ["make_mesh", "make_production_mesh", "rules_for_mesh",
           "smoke_mesh", "teardown"]


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes``. Over the running
    process group if there is one (its world size must be the mesh's),
    else over a new ``fake`` group in which this process is rank 0."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=n)
    elif dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{dist.get_world_size()}: teardown() first")
    return init_device_mesh("cpu", tuple(shape),
                            mesh_dim_names=tuple(axes))


def teardown() -> None:
    """Destroy the default process group (a new mesh size may follow)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def rules_for_mesh(mesh, *, seq_shard_batch1: bool = False
                   ) -> Dict[str, AxisRule]:
    """Logical-axis rule overrides for a given mesh.

    multi-pod: the "pod" axis joins the batch (pure DP across pods).
    seq_shard_batch1 (long_500k): KV-cache sequence spreads over every axis
    (batch=1 cannot shard), giving full sequence parallelism for the cache.
    """
    rules: Dict[str, AxisRule] = {}
    axes = tuple(mesh.mesh_dim_names)
    if "pod" in axes:
        rules["batch"] = ("pod", "data")
        rules["fsdp"] = ("data",)          # params replicated across pods
    if seq_shard_batch1:
        rules["kvseq"] = tuple(a for a in ("data", "model") if a in axes)
    return rules


def smoke_mesh(n: int = 1):
    """A (n, 1) ("data", "model") mesh over the running group, or a new
    ``fake`` group of ``n`` ranks (tests). JAX's caps ``n`` at its devices;
    a fake group has as many as asked."""
    return make_mesh((n, 1), ("data", "model"))
