"""The port's checkpoints, resilient loop and training CLI against the JAX
package's, on the CPU (smoke configs, fp32 unless stated).

Checkpoints: the same state written by both packages gives the same
manifest and leaf files byte for byte (JAX's leaf order and treedef), and
each package loads the other's; bf16 leaves round-trip as raw ``<V2``
bits. Then the port's copies of ``tests/test_ckpt_and_loop.py``. The
loop: from one JAX-written step-0 checkpoint, the port's loop and JAX's
give the same losses within 1e-4 relative over 10 steps, with the same
restarts and log under a fault at step 6. The compressed loop carries
its residual: its losses are JAX's functions called step by step within
1e-4 relative (JAX's own loop, whose jitted step keeps the zero residual
it was traced with, agrees only for the first two losses). A compressed
run checkpoints its residual beside the state (the residual first), so a
restart after a fault, or a resume whose newest residual was lost, repeats
the uninterrupted run's losses bit for bit.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jdata
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.train import loop as jloop
from repro.train import steps as jsteps
from repro_torch.ckpt import checkpoint as ckpt_module
from repro_torch.ckpt.checkpoint import (CheckpointError, CheckpointManager,
                                         clean_stale_tmp, latest_step,
                                         load_checkpoint, save_checkpoint,
                                         tree_flatten)
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, token_batches
from repro_torch.launch import train as train_cli
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import steps
from repro_torch.train.loop import LoopConfig, ResilientLoop

# test-scale schedule: short warmup so a 20-30 step run actually moves
OCFG = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100)


def small_cfg():
    return get_config("qwen3-8b").smoke()


def _state(cfg=None, seed=0):
    cfg = cfg or small_cfg()
    return steps.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                  device="cpu")


def _leaves(state):
    return tree_flatten(state)[0]


def _assert_equal_states(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# -- the on-disk layout, both ways -------------------------------------------

def test_checkpoint_files_are_jax_bytes(tmp_path):
    """One state written by each package: manifest.json and every
    leaf_<i>.npy byte for byte alike (JAX's sorted leaf order, treedef
    string, dtypes and shapes)."""
    jc = jax_get_config("qwen3-8b").smoke()
    js = jsteps.init_train_state(jax.random.key(0), jc)
    ts = steps.train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    pj = jck.save_checkpoint(str(tmp_path / "jax"), 3, js)
    pt = save_checkpoint(str(tmp_path / "port"), 3, ts)
    names = sorted(f.name for f in pj.iterdir())
    assert names == sorted(f.name for f in pt.iterdir())
    assert len(names) == len(jax.tree.leaves(js)) + 2
    for n in names:
        assert (pj / n).read_bytes() == (pt / n).read_bytes(), n


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jc = jax_get_config("zamba2-1.2b").smoke()
    js = jsteps.init_train_state(jax.random.key(1), jc)
    jck.save_checkpoint(str(tmp_path), 5, js)
    like = _state(get_config("zamba2-1.2b").smoke(), seed=9)
    got, step = load_checkpoint(str(tmp_path), like)
    assert step == 5
    assert list(got.params) == list(like.params)       # the port's order
    _assert_equal_states(got, steps.train_state_from_jax(
        jax.tree.map(np.asarray, js), "cpu"))


def test_port_checkpoint_loads_in_jax(tmp_path):
    ts = _state(get_config("xlstm-125m").smoke(), seed=2)
    save_checkpoint(str(tmp_path), 4, ts)
    jc = jax_get_config("xlstm-125m").smoke()
    like = jsteps.init_train_state(jax.random.key(0), jc)
    got, step = jck.load_checkpoint(str(tmp_path), like)
    assert step == 4
    for a, b in zip(jax.tree.leaves(got), _leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_bf16_checkpoint_round_trips_as_raw_bits(tmp_path):
    """bf16 parameters go to disk as their 2-byte bits under ``<V2`` with
    "bfloat16" in the manifest, and come back ``torch.equal``; a
    checkpoint JAX writes in bf16 reads the same way."""
    cfg = dataclasses.replace(small_cfg(), dtype="bfloat16")
    ts = _state(cfg)
    p = save_checkpoint(str(tmp_path / "port"), 1, ts)
    man = json.loads((p / "manifest.json").read_text())
    i = [k for k, leaf in enumerate(_leaves(ts))
         if leaf.dtype == torch.bfloat16][0]
    assert man["leaves"][i]["dtype"] == "bfloat16"
    assert np.load(p / f"leaf_{i}.npy").dtype.str == "|V2"
    got, _ = load_checkpoint(str(tmp_path / "port"), _state(cfg, seed=5))
    _assert_equal_states(got, ts)

    jc = dataclasses.replace(jax_get_config("qwen3-8b").smoke(),
                             dtype="bfloat16")
    js = jsteps.init_train_state(jax.random.key(3), jc)
    jck.save_checkpoint(str(tmp_path / "jax"), 2, js)
    got, _ = load_checkpoint(str(tmp_path / "jax"), _state(cfg, seed=5))
    _assert_equal_states(got, steps.train_state_from_jax(
        jax.tree.map(np.asarray, js), "cpu"))


def test_shardings_are_refused(tmp_path):
    """A shardings tree whose leaves are not NamedShardings (here the
    state's tensors) is refused; NamedShardings place the leaves
    (tests/test_torch_collectives.py)."""
    ts = _state()
    save_checkpoint(str(tmp_path), 1, ts)
    with pytest.raises(ValueError, match="shardings"):
        load_checkpoint(str(tmp_path), ts, shardings=ts)


# -- copies of tests/test_ckpt_and_loop.py -------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    restored, step = load_checkpoint(str(tmp_path), state)
    assert step == 7
    _assert_equal_states(restored, state)


def test_partial_checkpoint_ignored(tmp_path):
    """A checkpoint without _COMMITTED must be invisible to restore."""
    state = _state()
    save_checkpoint(str(tmp_path), 3, state)
    p = save_checkpoint(str(tmp_path), 9, state)
    (p / "_COMMITTED").unlink()
    assert latest_step(str(tmp_path)) == 3


def test_async_manager_and_gc(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, state)
    mgr.wait()
    steps_ = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir())
    assert steps_ == [3, 4]


def test_async_save_copies_before_returning(tmp_path):
    """The step after a save changes the state in place: the checkpoint
    holds the values at the save."""
    state = _state()
    want = [a.clone() for a in _leaves(state)]
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save_async(1, state)
    for a in _leaves(state):
        a.add_(1)
    mgr.wait()
    got, _ = load_checkpoint(str(tmp_path), state)
    for a, b in zip(_leaves(got), want):
        assert torch.equal(a, b)


def test_crashed_writer_tmp_is_invisible_and_gcd(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 5, state)
    wreck = tmp_path / "step_00000009.tmp"
    wreck.mkdir()
    (wreck / "manifest.json").write_text("{}")
    (wreck / "leaf_0.npy").write_bytes(b"\x93NUMPY partial")
    assert latest_step(str(tmp_path)) == 5          # tmp invisible + GC'd
    assert not wreck.exists()
    restored, step = load_checkpoint(str(tmp_path), state)
    assert step == 5
    _assert_equal_states(restored, state)


def test_manager_init_cleans_stale_tmp(tmp_path):
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000004.tmp").mkdir()
    CheckpointManager(str(tmp_path), keep=2)
    assert not list(tmp_path.glob("*.tmp"))
    assert clean_stale_tmp(str(tmp_path / "nope")) == 0


def test_corrupt_leaf_raises_checkpoint_error(tmp_path):
    state = _state()
    p = save_checkpoint(str(tmp_path), 4, state)
    (p / "leaf_0.npy").write_bytes(b"\x93NUMPY truncated")
    with pytest.raises(CheckpointError) as ei:
        load_checkpoint(str(tmp_path), state)
    msg = str(ei.value)
    assert "step 4" in msg and "leaf 0" in msg and str(p) in msg
    (p / "leaf_0.npy").unlink()
    with pytest.raises(CheckpointError, match="leaf 0"):
        load_checkpoint(str(tmp_path), state)


def test_wrong_architecture_raises_checkpoint_error(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), 2, state)
    leaves = _leaves(state)
    with pytest.raises(CheckpointError, match="leaves"):
        load_checkpoint(str(tmp_path), leaves[:-1])  # fewer leaves
    reshaped = [torch.zeros((3, 3))] + leaves[1:]
    with pytest.raises(CheckpointError, match="leaf 0 has shape"):
        load_checkpoint(str(tmp_path), reshaped)


def test_data_stream_determinism():
    dc = DataConfig(vocab=97, seq_len=16, global_batch=4)
    a = next(token_batches(dc, start_step=5))
    b = next(token_batches(dc, start_step=5))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    dc2 = DataConfig(vocab=97, seq_len=16, global_batch=4, n_hosts=2,
                     host_id=1)
    c = next(token_batches(dc2, start_step=5))
    assert not np.array_equal(a["tokens"][:2], c["tokens"])


def _fault_at(*steps_):
    pending = set(steps_)

    def fault(step):
        if step in pending:
            pending.discard(step)
            raise RuntimeError("injected device failure")
    return fault


def test_loop_recovers_from_injected_failure(tmp_path):
    cfg = small_cfg()
    loop = ResilientLoop(
        cfg, LoopConfig(total_steps=25, ckpt_every=5, ckpt_dir=str(tmp_path),
                        log_every=100),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4),
        ocfg=OCFG, fault_hook=_fault_at(15), device="cpu")
    out = loop.run()
    assert out["final_step"] == 25
    assert out["restarts"] == 1
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
    assert latest_step(str(tmp_path)) == 25


def test_loss_decreases_on_markov_stream(tmp_path):
    cfg = small_cfg()
    loop = ResilientLoop(
        cfg, LoopConfig(total_steps=30, ckpt_every=100,
                        ckpt_dir=str(tmp_path), log_every=100),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8),
        ocfg=OCFG, device="cpu")
    losses = [m["loss"] for m in loop.run()["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, \
        f"no learning: {losses[:3]} -> {losses[-3:]}"


def test_compressed_grads_still_learn(tmp_path):
    cfg = small_cfg()
    loop = ResilientLoop(
        cfg, LoopConfig(total_steps=20, ckpt_every=100,
                        ckpt_dir=str(tmp_path), log_every=100,
                        compress_grads=True),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8),
        ocfg=OCFG, device="cpu")
    losses = [m["loss"] for m in loop.run()["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_loop_without_checkpoints_writes_nothing(tmp_path, monkeypatch):
    """``ckpt_dir=None``: no save and no restore; a restart begins again
    from the seed, so the run repeats the first steps' losses."""
    monkeypatch.chdir(tmp_path)
    cfg = small_cfg()
    loop = ResilientLoop(
        cfg, LoopConfig(total_steps=4, ckpt_dir=None, log_every=100),
        DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
        ocfg=OCFG, fault_hook=_fault_at(2), device="cpu")
    out = loop.run()
    assert out["restarts"] == 1 and out["final_step"] == 4
    log = out["metrics"]
    assert [m["step"] for m in log] == [1, 2, 1, 2, 3, 4]
    assert [m["loss"] for m in log[:2]] == [m["loss"] for m in log[2:4]]
    assert not list(tmp_path.iterdir())


# -- the loop against JAX's ------------------------------------------------------

def _from_one_jax_checkpoint(tmp_path, arch, ocfg):
    """A JAX-written step-0 checkpoint, copied for each loop."""
    jc = jax_get_config(arch).smoke()
    js = jsteps.init_train_state(jax.random.key(4), jc, ocfg)
    jck.save_checkpoint(str(tmp_path / "jax"), 0, js)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return jc, js


@pytest.mark.parametrize("fault", [None, 6])
def test_loop_matches_jax_from_one_checkpoint(tmp_path, capsys, fault):
    """10 steps from one JAX step-0 checkpoint: losses within 1e-4
    relative of JAX's loop; under a fault at step 6 (checkpoints every 4)
    the same restart count, final step and log (steps 1-6, then 5-10
    again from the step-4 checkpoint)."""
    ocfg = jadamw.AdamWConfig(*OCFG)
    jc, _ = _from_one_jax_checkpoint(tmp_path, "qwen3-8b", ocfg)
    dk = dict(vocab=jc.vocab, seq_len=32, global_batch=4)
    lk = dict(total_steps=10, ckpt_every=4, log_every=100)
    hook = (lambda: None if fault is None else _fault_at(fault))
    want = jloop.ResilientLoop(
        jc, jloop.LoopConfig(ckpt_dir=str(tmp_path / "jax"), **lk),
        jdata.DataConfig(**dk), ocfg, fault_hook=hook()).run()
    got = ResilientLoop(
        small_cfg(), LoopConfig(ckpt_dir=str(tmp_path / "port"), **lk),
        DataConfig(**dk), OCFG, fault_hook=hook(), device="cpu").run()
    for k in ("final_step", "restarts"):
        assert got[k] == want[k]
    assert [m["step"] for m in got["metrics"]] == \
        [m["step"] for m in want["metrics"]]
    for g, w in zip(got["metrics"], want["metrics"]):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * w["loss"]
    if fault:
        assert [m["step"] for m in got["metrics"]] == \
            [1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9, 10]
        out = capsys.readouterr().out
        assert out.count("[loop] restored checkpoint at step 0") == 2
        assert out.count("[loop] restored checkpoint at step 4") == 2
        assert out.count("[loop] step 6 FAILED (RuntimeError: injected "
                         "device failure); restart 1/3") == 2
    assert latest_step(str(tmp_path / "port")) == 10


def test_compressed_loop_carries_its_residual(tmp_path):
    """4 compressed steps (lr 1e-2, no warmup) from one JAX checkpoint:
    the port's loop against JAX's ``compress_grads`` and
    ``adamw_update`` called step by step with the residual carried,
    losses within 1e-4 relative; against JAX's jitted loop (whose residual
    stays the zero it was traced with) at the first two losses, where the
    residual has not yet entered the loss. By the fourth, JAX's loop is
    farther from the carried residual's loss than that."""
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100)
    jc, js = _from_one_jax_checkpoint(tmp_path, "qwen3-8b", ocfg)
    shutil.copytree(tmp_path / "jax", tmp_path / "jax_loop")
    dk = dict(vocab=jc.vocab, seq_len=32, global_batch=4)
    lk = dict(total_steps=4, ckpt_every=100, log_every=100,
              compress_grads=True)
    loop = ResilientLoop(
        small_cfg(), LoopConfig(ckpt_dir=str(tmp_path / "port"), **lk),
        DataConfig(**dk), AdamWConfig(*ocfg), device="cpu")
    got = [m["loss"] for m in loop.run()["metrics"]]
    assert any(bool(e.abs().max() > 0) for _, e in
               lm.tree_leaves(loop._comp_state.error))

    vg = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: jlm.loss_fn(q, b, jc))(p))
    upd = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, ocfg))
    state, comp = js, jcompress.init_compression(js.params)
    batches = jdata.token_batches(jdata.DataConfig(**dk), jc)
    ref = []
    for _ in range(4):
        b = {k: jnp.asarray(v) for k, v in next(batches).items()}
        loss, g = vg(state.params, b)
        ref.append(float(loss))
        g, comp = jcompress.compress_grads(g, comp)
        p, o, _ = upd(g, state.opt, state.params)
        state = jsteps.TrainState(p, o)
    for g_, r in zip(got, ref):
        assert abs(g_ - r) <= 1e-4 * r

    jl = jloop.ResilientLoop(
        jc, jloop.LoopConfig(ckpt_dir=str(tmp_path / "jax_loop"), **lk),
        jdata.DataConfig(**dk), ocfg).run()
    jl = [m["loss"] for m in jl["metrics"]]
    for g_, w in zip(got[:2], jl[:2]):
        assert abs(g_ - w) <= 1e-5 * w
    assert abs(jl[3] - ref[3]) > abs(got[3] - ref[3])


# -- the compressed loop's restart (the residual committed with the state) ------

def _compressed_loop(ckpt_dir, total_steps=8, fault=None, ckpt_every=4,
                     keep=2):
    cfg = small_cfg()
    return ResilientLoop(
        cfg, LoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                        ckpt_dir=str(ckpt_dir), keep=keep, log_every=100,
                        compress_grads=True),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
        ocfg=OCFG, fault_hook=None if fault is None else _fault_at(fault),
        device="cpu")


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's threaded reductions may sum in
    another order from run to run (seen at B 8 x 64), which would hide
    what a bit-for-bit restart check is after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_keeping_states(loop):
    """``loop.run()``, and the state each step returned."""
    states, step = [], loop._step

    def spy(state, batch):
        out = step(state, batch)
        states.append(out[0])
        return out

    loop._step = spy
    return loop.run(), states


def _same_losses(got, want):
    by_step = {m["step"]: m["loss"] for m in want["metrics"]}
    return [m["loss"] for m in got["metrics"]] == \
        [by_step[m["step"]] for m in got["metrics"]]


def test_compressed_restart_resumes_the_run(tmp_path, one_thread):
    """8 compressed steps, checkpoints every 4, a fault at step 6: the
    re-run steps' losses equal the uninterrupted run's bit for bit (the
    residual of step 4 is restored with the state), as the uncompressed
    loop's do; the state's checkpoint is, byte for byte, what
    ``save_checkpoint`` (JAX's bytes) writes for the loop's final state."""
    want = _compressed_loop(tmp_path / "whole").run()
    got, states = _run_keeping_states(
        _compressed_loop(tmp_path / "faulted", fault=6))
    assert got["restarts"] == 1 and got["final_step"] == 8
    assert [m["step"] for m in got["metrics"]] == [1, 2, 3, 4, 5, 6,
                                                   5, 6, 7, 8]
    assert _same_losses(got, want)
    plain = tmp_path / "plain"
    save_checkpoint(str(plain), 8, states[-1])
    want_files = sorted((plain / "step_00000008").iterdir())
    for run in ("whole", "faulted"):
        root = tmp_path / run
        assert latest_step(str(root)) == 8
        got_files = sorted((root / "step_00000008").iterdir())
        assert [f.name for f in got_files] == [f.name for f in want_files]
        for g, w in zip(got_files, want_files):
            assert g.read_bytes() == w.read_bytes(), (run, g.name)
        assert (root / "residual" / "step_00000008" / "_COMMITTED").exists()


def test_lost_latest_residual_resumes_from_the_step_before(tmp_path,
                                                          one_thread):
    """A compressed run's newest state without its residual is passed
    over: the restore takes the newest step with both, and the resumed
    run's losses equal an uninterrupted run's bit for bit."""
    want = _compressed_loop(tmp_path / "whole", total_steps=12).run()
    _compressed_loop(tmp_path / "cut", total_steps=8).run()
    shutil.rmtree(tmp_path / "cut" / "residual" / "step_00000008")
    assert latest_step(str(tmp_path / "cut")) == 8
    got = _compressed_loop(tmp_path / "cut", total_steps=12).run()
    assert [m["step"] for m in got["metrics"]] == list(range(5, 13))
    assert _same_losses(got, want)


def test_residual_is_committed_before_the_state(tmp_path, monkeypatch):
    """One thread commits the residual, then the state: a save that dies
    writing the residual leaves that step's state uncommitted, so no
    restore pairs a state with a missing residual."""
    loop = _compressed_loop(tmp_path)
    state, _ = loop._init_state()
    written = []
    write = ckpt_module._write

    def failing(d, step, leaves, treedef):
        written.append((d, step))
        if d == loop.residual_dir and step == 8:
            raise OSError("disk full")
        return write(d, step, leaves, treedef)

    monkeypatch.setattr(ckpt_module, "_write", failing)
    loop._save(4, state)
    loop._wait()
    loop._save(8, state)
    with pytest.raises(OSError, match="disk full"):
        loop._wait()
    assert written == [(loop.residual_dir, 4), (str(tmp_path), 4),
                       (loop.residual_dir, 8)]
    assert latest_step(str(tmp_path)) == 4


def test_compressed_restore_without_a_residual_carries_zeros(tmp_path,
                                                             capsys):
    """A checkpoint with no residual beside it (written by an uncompressed
    run, or by JAX) restores with the zero residual JAX's loop carries;
    one with a residual restores that residual exactly."""
    loop = _compressed_loop(tmp_path, total_steps=4)
    loop.run()
    saved = [e.clone() for _, e in lm.tree_leaves(loop._comp_state.error)]
    assert any(bool(e.abs().max() > 0) for e in saved)

    again = _compressed_loop(tmp_path, total_steps=4)
    _, start = again._init_state()
    assert start == 4
    for (_, e), s in zip(lm.tree_leaves(again._comp_state.error), saved):
        assert torch.equal(e, s)

    shutil.rmtree(tmp_path / "residual")
    bare = _compressed_loop(tmp_path, total_steps=4)
    _, start = bare._init_state()
    assert start == 4
    assert all(not bool(e.any())
               for _, e in lm.tree_leaves(bare._comp_state.error))
    assert "[loop] no residual at step 4: zeros" in capsys.readouterr().out


def test_residuals_are_pruned_with_the_checkpoints(tmp_path):
    """``keep`` prunes the residual directories in step with the state's,
    and ``latest_step`` never counts the residual directory."""
    _compressed_loop(tmp_path, total_steps=10, ckpt_every=2, keep=2).run()
    state_steps = sorted(p.name for p in tmp_path.iterdir()
                         if p.name.startswith("step_"))
    res_steps = sorted(p.name for p in (tmp_path / "residual").iterdir())
    assert state_steps == res_steps == ["step_00000008", "step_00000010"]
    assert latest_step(str(tmp_path)) == 10


# -- the CLI and the device -------------------------------------------------------

def test_cli_runs_on_the_cpu(tmp_path, capsys):
    train_cli.main(["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "16",
                    "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[train] done: step 3, loss ")
    assert last.endswith(", restarts=0")
    assert latest_step(str(tmp_path)) == 3


def test_entry_points_without_a_device_raise(monkeypatch, tmp_path):
    """Training runs on the CUDA device unless given another, and raises
    without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_cfg()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_train_state(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResilientLoop(cfg, LoopConfig(ckpt_dir=str(tmp_path)),
                      DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
