"""The port's explicit collectives, uniform pipeline and sharded restore
(slice 8c) against the JAX package, on the CPU.

``ring_matmul_overlapped`` and ``sp_decode_attention`` run on 8 gloo
processes (the ring over all 8; the sequence-parallel decode over the
"model" axis of a (2, 4) mesh), JAX's on 8 forced host devices, each side
in processes of its own, on the same numpy inputs and at JAX's sizes and
tolerances (tests/test_parallel.py): the ring M 64, K 32, N 80 at 1e-4;
the decode B 2, H 4, D 16, S 32, pos 17 at 2e-5; ``pipeline_forward``
(the port's runs on one device's schedule, in this process) 8 stages, B
16, D 32 at 1e-4. The sharded restore loads a checkpoint onto a gloo
(1, 1) mesh and onto two gloo processes, as JAX's
``test_elastic_restore_across_data_layout`` does on one device.
"""
import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.parallel.collectives import (sp_decode_combine,
                                              sp_decode_partial)
from repro_torch.parallel.pipeline_par import pipeline_forward

SRC = Path(__file__).resolve().parents[1] / "src"


def _inputs():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(64, 32).astype(np.float32),
            "w": rng.randn(32, 80).astype(np.float32),
            "q": rng.randn(2, 4, 16).astype(np.float32),
            "kc": rng.randn(2, 32, 4, 16).astype(np.float32),
            "vc": rng.randn(2, 32, 4, 16).astype(np.float32),
            "ws": (rng.randn(8, 32, 32) * 0.2).astype(np.float32),
            "xp": rng.randn(16, 32).astype(np.float32)}


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    np.savez(d / "in.npz", **_inputs())
    return d


@pytest.fixture(scope="module")
def jax_out(data):
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import jax, jax.numpy as jnp, numpy as np
        from repro.launch.mesh import compat_make_mesh
        from repro.parallel.collectives import (ring_matmul_overlapped,
                                                sp_decode_attention)
        from repro.parallel.pipeline_par import pipeline_forward
        a = np.load({str(data / "in.npz")!r})
        ring = ring_matmul_overlapped(
            jnp.asarray(a["x"]), jnp.asarray(a["w"]),
            compat_make_mesh((1, 8), ("data", "model")))
        sp = sp_decode_attention(
            jnp.asarray(a["q"]), jnp.asarray(a["kc"]), jnp.asarray(a["vc"]),
            jnp.asarray(17), compat_make_mesh((2, 4), ("data", "model")))
        pipe = pipeline_forward(
            lambda w, h: jnp.tanh(h @ w), jnp.asarray(a["ws"]),
            jnp.asarray(a["xp"]), compat_make_mesh((8,), ("pod",)),
            axis="pod", n_microbatches=4)
        np.savez({str(data / "jax.npz")!r}, ring=np.asarray(ring),
                 sp=np.asarray(sp), pipe=np.asarray(pipe))
    """)
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return np.load(data / "jax.npz")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo(world: int, body: str, d: Path):
    """Run ``body`` on ``world`` gloo processes (``rank``, ``world``,
    ``out`` (this rank's npz path) and ``a`` (the inputs) defined);
    returns each rank's saved arrays."""
    code = textwrap.dedent("""
        import os, sys
        import numpy as np, torch
        import torch.distributed as dist
        rank, world = int(sys.argv[1]), int(sys.argv[2])
        dist.init_process_group("gloo", init_method=sys.argv[3], rank=rank,
                                world_size=world)
        a = np.load(sys.argv[4])
        out = sys.argv[5] % rank
    """) + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    url = f"tcp://localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), url,
         str(d / "in.npz"), str(d / "rank%d.npz")], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(world)]


@functools.lru_cache(maxsize=None)
def _port_collectives(d: Path):
    return _gloo(8, """
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.parallel.collectives import (ring_matmul_overlapped,
                                                      sp_decode_attention)
        t = {k: torch.from_numpy(v) for k, v in a.items()}
        ring = ring_matmul_overlapped(t["x"][8 * rank:8 * (rank + 1)],
                                      t["w"][:, 10 * rank:10 * (rank + 1)])
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        c = mesh.get_local_rank("model")
        sp = sp_decode_attention(t["q"], t["kc"][:, 8 * c:8 * (c + 1)],
                                 t["vc"][:, 8 * c:8 * (c + 1)], 17, mesh)
        np.savez(out, ring=ring.numpy(), sp=sp.numpy())
    """, d)


def test_ring_matmul_overlapped_matches_jax(data, jax_out):
    """Each rank's (64, 10) columns of x @ w, rows gathered around the
    ring, side by side equal JAX's shard_map result and the product."""
    ranks = _port_collectives(data)
    got = np.concatenate([r["ring"] for r in ranks], axis=1)
    a = np.load(data / "in.npz")
    np.testing.assert_allclose(got, jax_out["ring"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, a["x"] @ a["w"], rtol=1e-4, atol=1e-4)


def test_sp_decode_attention_matches_jax(data, jax_out):
    """Every rank ends with JAX's output: the (m, l) combine over the four
    sequence shards of its "model" group."""
    ranks = _port_collectives(data)
    for r in ranks:
        np.testing.assert_allclose(r["sp"], jax_out["sp"], rtol=2e-5,
                                   atol=2e-5)


def test_sp_decode_combine_in_one_process_matches_jax(data, jax_out):
    """The partials of four slices combined in one process (what phase 19
    runs on one card) give the same output as the all-reduces."""
    a = {k: torch.from_numpy(v) for k, v in np.load(data / "in.npz").items()}
    parts = [sp_decode_partial(a["q"], a["kc"][:, 8 * c:8 * (c + 1)],
                               a["vc"][:, 8 * c:8 * (c + 1)], 17, 8 * c)
             for c in range(4)]
    np.testing.assert_allclose(sp_decode_combine(parts).numpy(),
                               jax_out["sp"], rtol=2e-5, atol=2e-5)


def test_pipeline_forward_matches_jax(data, jax_out):
    a = {k: torch.from_numpy(v) for k, v in np.load(data / "in.npz").items()}
    got = pipeline_forward(lambda w, h: torch.tanh(h @ w), a["ws"], a["xp"],
                           4)
    np.testing.assert_allclose(got.numpy(), jax_out["pipe"], rtol=1e-4,
                               atol=1e-4)
    want = a["xp"]
    for w in a["ws"]:
        want = torch.tanh(want @ w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_pipeline_forward_takes_a_tree_and_refuses_a_ragged_batch():
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn(3, 8, 8, generator=g),
         "b": torch.randn(3, 8, generator=g)}
    x = torch.randn(6, 8, generator=g)
    got = pipeline_forward(lambda s, h: h @ s["w"] + s["b"], p, x, 3)
    want = x
    for i in range(3):
        want = want @ p["w"][i] + p["b"][i]
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(lambda s, h: h, p, x, 4)


_RESTORE = """
    import dataclasses
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.ckpt.checkpoint import (load_checkpoint,
                                             save_checkpoint, tree_flatten)
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel.sharding import (DEFAULT_RULES, named,
                                               param_shardings)
    from repro_torch.train.steps import TrainState, init_train_state
    cfg = dataclasses.replace(get_config("qwen3_8b").smoke(), n_layers=2)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ckpt = os.path.join(os.path.dirname(out), "ckpt")
    if rank == 0:
        save_checkpoint(ckpt, 11, state)
    dist.barrier()
    mesh = init_device_mesh("cpu", (world, 1),
                            mesh_dim_names=("data", "model"))
    sh = TrainState(param_shardings(mesh, DEFAULT_RULES, state.params),
                    AdamWState(named(mesh, DEFAULT_RULES, ()),
                               param_shardings(mesh, DEFAULT_RULES,
                                               state.opt.m),
                               param_shardings(mesh, DEFAULT_RULES,
                                               state.opt.v)))
    got, step = load_checkpoint(ckpt, state, shardings=sh)
    leaves, _ = tree_flatten(got)
    want, _ = tree_flatten(state)
    places, _ = tree_flatten(sh)
    cut = 0
    for g, w, p in zip(leaves, want, places):
        assert tuple(g.placements) == tuple(p.placements)
        assert g.dtype == w.dtype and torch.equal(g.full_tensor(), w)
        cut += g.to_local().numel() < w.numel()
    np.savez(out, step=step, cut=cut, n=len(leaves))
"""


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_restore_places_every_leaf(world, tmp_path):
    """``load_checkpoint(shardings=)`` on a (world, 1) gloo mesh: every
    leaf comes back with its ``param_shardings`` placement and the saved
    values; on two ranks the FSDP-cut leaves hold half each."""
    np.savez(tmp_path / "in.npz", x=np.zeros(1))
    ranks = _gloo(world, _RESTORE, tmp_path)
    for r in ranks:
        assert int(r["step"]) == 11
        assert (int(r["cut"]) > 0) == (world > 1)
