"""The port's training pieces against the JAX package, on the CPU.

Inputs are numpy arrays from a seed; JAX's parameters and optimizer
state are carried across with ``train_state_from_jax``. Tolerances:
``cross_entropy`` within 1e-6 (fp32); ``loss_fn`` within 1e-5 relative
and each gradient leaf within 1e-4 x its max|JAX leaf| (fp32 sums in
another order through a whole smoke model); ``adamw_update`` within
1e-6 x max|JAX leaf| (the same elementwise fp32 arithmetic); the block
quantisers' codes equal and scales and residuals within 1e-7; the data
streams byte for byte; remat against no remat bit for bit (the same
operations recomputed on the same inputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jdata
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.quant import core as jquant
from repro.train import steps as jsteps
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs import get_config
from repro_torch.data import pipeline as data
from repro_torch.models import layers, lm
from repro_torch.optim import adamw, compress
from repro_torch.quant import core as quant
from repro_torch.train import steps

ARCHS = ["qwen3-8b", "dbrx-132b", "zamba2-1.2b", "xlstm-125m",
         "musicgen-medium"]


def _jax_at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _close_leaves(got_tree, want_tree, rtol):
    """Every leaf of the port's tree within rtol x max|JAX leaf| of JAX's
    leaf at the same path."""
    n = 0
    for path, got in lm.tree_leaves(got_tree):
        want = _jax_at(want_tree, path).astype(np.float32)
        tol = rtol * max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= tol, f"{'.'.join(path)}: {err:.3e} > {tol:.3e}"
        n += 1
    return n


def _smoke_pair(arch, seed=0):
    """JAX's smoke TrainState and the port's copy of it."""
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    js = jsteps.init_train_state(jax.random.key(seed), jc)
    ts = steps.train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    return jc, tc, js, ts


def _batch(cfg, seed=1, B=2, S=16):
    """One batch of JAX's data stream (numpy), as both packages take it."""
    return next(jdata.token_batches(
        jdata.DataConfig(cfg.vocab, S, B, seed=seed), cfg))


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# -- cross entropy ------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want, jgrad = jax.value_and_grad(
        lambda x: jlayers.cross_entropy(x, jnp.asarray(labels), jm))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = layers.cross_entropy(x, torch.from_numpy(labels), tm)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-6)


def test_cross_entropy_reads_bf16_logits_in_fp32():
    """bf16 logits widen to fp32 before any arithmetic: the loss equals
    the fp32 loss of the same (bf16-exact) values."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 300)).astype(np.float32))
    x = x.to(torch.bfloat16)
    lab = torch.from_numpy(rng.integers(0, 300, 4))
    assert torch.equal(layers.cross_entropy(x, lab),
                       layers.cross_entropy(x.float(), lab))


# -- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` and the gradient ``train_step`` takes against
    ``jax.value_and_grad(lm.loss_fn)`` on the same parameters and batch
    (dbrx: the aux loss; musicgen: the frontend cut)."""
    jc, tc, js, ts = _smoke_pair(arch)
    b = _batch(jc)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, _jb(b), jc)))(js.params)
    got, grads = steps.loss_and_grads(ts.params, _tb(b), tc)
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert torch.equal(got, lm.loss_fn(ts.params, _tb(b), tc))
    n = _close_leaves(grads, jgrads, 1e-4)
    assert n == len(jax.tree.leaves(jgrads))


def test_loss_masks_the_padded_vocab():
    """The pad columns take no probability: raising them changes nothing."""
    cfg = dataclasses.replace(get_config("qwen3-8b").smoke(), vocab=500)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _tb(_batch(cfg))
    base = lm.loss_fn(params, b, cfg)
    params["lm_head"][:, 500:] = 100.0
    assert torch.equal(lm.loss_fn(params, b, cfg), base)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "dbrx-132b", "zamba2-1.2b",
                                  "xlstm-125m"])
def test_remat_changes_no_gradient(arch, policy):
    """Remat in either policy gives the gradients of no remat bit for bit,
    and the loss too."""
    cfg = get_config(arch).smoke()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _tb(_batch(cfg))
    loss0, g0 = steps.loss_and_grads(params, b, cfg)
    rcfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    loss1, g1 = steps.loss_and_grads(params, b, rcfg)
    assert torch.equal(loss0, loss1)
    for (path, a), (_, c) in zip(lm.tree_leaves(g0), lm.tree_leaves(g1)):
        assert torch.equal(a, c), path


class _CountProducts(TorchDispatchMode):
    """Counts the ``mm`` and ``bmm`` calls that reach the kernels."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_recompute_what_they_say():
    """"full" recomputes every product of a layer in the backward; "dots"
    keeps the products without batch dimensions (``mm``: as many run as
    without remat) and recomputes the batched ones (``bmm``: the
    attention scores)."""
    cfg = get_config("qwen3-8b").smoke()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = _tb(_batch(cfg, S=40))              # past attn_chunk: chunked path
    runs = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        with _CountProducts() as count:
            steps.loss_and_grads(params, b, c)
        runs[(remat, policy)] = count.n
    none, full, dots = runs[(False, "full")], runs[(True, "full")], \
        runs[(True, "dots")]
    assert full["mm"] > dots["mm"] == none["mm"]
    assert full["bmm"] == dots["bmm"] > none["bmm"]


def test_training_takes_each_stacked_gradient_once():
    """The layer loop unbinds each stacked leaf once: the one backward node
    feeding a stacked leaf's gradient is an unbind, which stacks the
    layers' gradients once (an index a layer would write a zero-filled
    gradient the size of the stack L times)."""
    cfg = get_config("zamba2-1.2b").smoke()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    live = lm.tree_map(lambda a: a.detach().requires_grad_(), params)
    stacked = {id(a) for _, a in lm.tree_leaves(live["blocks"])}
    loss = lm.loss_fn(live, _tb(_batch(cfg)), cfg)
    feeders, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in stacked:
                feeders.setdefault(id(var), []).append(type(fn).__name__)
            todo.append(nxt)
    assert len(feeders) == len(stacked)
    assert all(f == ["UnbindBackward0"] for f in feeders.values()), feeders


def test_train_step_matches_jax():
    """One ``train_step``: loss, grad norm and lr against JAX's
    ``train_step`` on the same state; the new state is the port's
    ``loss_and_grads`` then ``adamw_update`` bit for bit (each held
    against JAX above and below), written into the state it was given,
    as JAX's loop donates it. (The new parameters are not held against
    JAX's: Adam's first step moves each by about lr x sign(g), so the
    1e-4 gradient tolerance flips it where g is near 0.)"""
    jc, tc, js, ts = _smoke_pair("zamba2-1.2b")
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    tcfg = adamw.AdamWConfig(*ocfg)
    b = _batch(jc)
    _, jm = jax.jit(lambda s: jsteps.train_step(s, _jb(b), jc, ocfg))(js)
    twin = steps.TrainState(lm.tree_map(torch.clone, ts.params),
                            adamw.init_adamw(ts.params, tcfg))
    tnew, tm = steps.train_step(ts, _tb(b), tc, tcfg)
    for k in ("loss", "grad_norm", "lr"):
        assert abs(tm[k].item() - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    loss, grads = steps.loss_and_grads(twin.params, _tb(b), tc)
    p2, o2, m2 = adamw.adamw_update(grads, twin.opt, twin.params, tcfg)
    assert torch.equal(loss, tm["loss"]) and torch.equal(m2["lr"], tm["lr"])
    assert tnew.opt.step.item() == 1
    for a, c in zip(tree_flatten(tnew)[0], tree_flatten(
            steps.TrainState(p2, o2))[0]):
        assert torch.equal(a, c)
    assert tnew.params["embed"] is ts.params["embed"]


# -- AdamW --------------------------------------------------------------------

def _grads_like(tree, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(a.dtype),
        jax.tree.map(np.asarray, tree))


def _bf16_ulp_close(got, want):
    """Every element within one bf16 ulp of JAX's (relative 2^-8, or the
    smallest normal's ulp near 0)."""
    g = got.float().numpy()
    w = want.astype(np.float32)
    ulp = np.maximum(np.abs(w), np.finfo(np.float32).tiny) * 2.0 ** -7
    assert (np.abs(g - w) <= ulp).all()


@pytest.mark.parametrize("state_dtype,n_steps", [("float32", 4),
                                                 ("bfloat16", 2)])
def test_adamw_update_matches_jax(state_dtype, n_steps):
    """Updates fed the same gradients as JAX (the second clipped), across
    the warmup into the cosine decay in fp32: parameters, m, v, lr and
    grad norm within 1e-6 relative. With ``opt_state_dtype`` bf16 the
    moments are bf16 in both; the first update (from zero moments) is
    held at 1e-6 too, the second's moments within one bf16 ulp: XLA
    contracts JAX's ``m * b1 + (1 - b1) * g`` into an FMA on the CPU, an
    fp32 ulp from the two roundings here (and on the card), and rounding
    to bf16 can then fall either side."""
    jc = dataclasses.replace(jax_get_config("qwen3-8b").smoke(),
                             opt_state_dtype=state_dtype)
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                              state_dtype=state_dtype)
    js = jsteps.init_train_state(jax.random.key(0), jc, ocfg)
    ts = steps.train_state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    tcfg = adamw.AdamWConfig(*ocfg)
    jupd = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, ocfg))
    jp, jo = js.params, js.opt
    tp, to = ts.params, ts.opt
    for i in range(n_steps):
        g = _grads_like(jp, i, scale=1.0 if i == 1 else 1e-2)
        jp, jo, jm = jupd(g, jo, jp)
        tp, to, tm = adamw.adamw_update(lm.params_from_jax(g, "cpu"), to,
                                        tp, tcfg)
        for k in ("lr", "grad_norm"):
            assert abs(tm[k].item() - float(jm[k])) <= 1e-6 * float(jm[k])
        assert to.step.dtype == torch.int32 and to.step.item() == i + 1
        _close_leaves(tp, jp, 1e-6)
        if state_dtype == "bfloat16" and i > 0:
            for path, a in lm.tree_leaves(to.m):
                _bf16_ulp_close(a, _jax_at(jo.m, path))
            for path, a in lm.tree_leaves(to.v):
                _bf16_ulp_close(a, _jax_at(jo.v, path))
        else:
            _close_leaves(to.m, jo.m, 1e-6)
            _close_leaves(to.v, jo.v, 1e-6)
    assert float(jm["grad_norm"]) > 0
    assert to.m["embed"].dtype == layers.dtype_of(state_dtype)


def test_adamw_decays_stacked_gains_and_not_final_norm():
    """JAX's weight decay takes every leaf of two or more dimensions: on
    the stacked tree that is each layer's gain (ln1: (L, d)) and not
    final_norm (d,). With zero gradients the update is the decay alone."""
    jc, tc, js, ts = _smoke_pair("qwen3-8b")
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    zeros = jax.tree.map(jnp.zeros_like, js.params)
    jp, _, _ = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, ocfg))(
        zeros, js.opt, js.params)
    ln1 = ts.params["blocks"]["ln1"].clone()
    tp, _, tm = adamw.adamw_update(lm.tree_map(torch.zeros_like, ts.params),
                                   ts.opt, ts.params, adamw.AdamWConfig(*ocfg))
    assert ln1.dim() == 2
    assert torch.equal(tp["final_norm"], torch.ones(tc.d_model))
    decayed = ln1 - tm["lr"] * (ocfg.weight_decay * ln1)
    assert torch.equal(tp["blocks"]["ln1"], decayed)
    assert not torch.equal(tp["blocks"]["ln1"], ln1)
    _close_leaves(tp, jp, 1e-6)


def test_lr_schedule_matches_jax():
    ocfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=40)
    for s in (0, 1, 6, 7, 8, 23, 39, 40, 55):
        want = float(jadamw.lr_schedule(jnp.asarray(s, jnp.int32), ocfg))
        got = adamw.lr_schedule(torch.tensor(s, dtype=torch.int32),
                                adamw.AdamWConfig(*ocfg))
        assert got.dtype == torch.float32
        assert abs(got.item() - want) <= 1e-6 * max(want, 1e-12), s


def test_adamw_slices_a_large_leaf_as_the_whole(monkeypatch):
    """The update of a leaf in slices of its leading axis equals the
    update of the whole leaf."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal((6, 5, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 5, 4)).astype(np.float32))
    cfg = adamw.AdamWConfig(warmup_steps=0)

    def run():
        params = {"w": p.clone()}
        st = adamw.init_adamw(params, cfg)
        return adamw.adamw_update({"w": g}, st, params, cfg)

    whole, st_whole, _ = run()
    monkeypatch.setattr(adamw, "_SLICE", 40)
    assert len(adamw._slices(p)) == 3
    sliced, st_sliced, _ = run()
    assert torch.equal(whole["w"], sliced["w"])
    assert torch.equal(st_whole.m["w"], st_sliced.m["w"])
    assert torch.equal(st_whole.v["w"], st_sliced.v["w"])


# -- block quantisers and the gradient compression ---------------------------

@pytest.mark.parametrize("n,block", [(5000, 2048), (4096, 2048), (7, 4)])
def test_quantize_blocks_matches_jax(n, block):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3).astype(np.float32).reshape(-1, 1)
    x[0] = 0.0
    jq, js = jquant.quantize_blocks(jnp.asarray(x), block)
    tq, ts = quant.quantize_blocks(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and ts.shape == (-(-n // block), 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    want = jquant.dequantize_blocks(jq, js, x.shape)
    got = quant.dequantize_blocks(tq, ts, x.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-7)


def test_compress_grads_matches_jax():
    """Two rounds of ``compress_grads`` on a smoke model's gradient tree,
    the second with the first's residual: grads and residuals within
    1e-7; ``compressed_bytes`` equal."""
    jc, tc, js, ts = _smoke_pair("qwen3-8b")
    jstate = jcompress.init_compression(js.params)
    tstate = compress.init_compression(ts.params)
    for i in range(2):
        g = _grads_like(js.params, 10 + i)
        # unjitted: jitted, XLA's CPU code put one code of these 32768 a
        # step away from the unjitted function's (and the port's)
        jg, jstate = jcompress.compress_grads(g, jstate)
        tg, tstate = compress.compress_grads(lm.params_from_jax(g, "cpu"),
                                             tstate)
        for path, a in lm.tree_leaves(tg):
            np.testing.assert_allclose(a.numpy(), _jax_at(jg, path), rtol=0,
                                       atol=1e-7)
        for path, a in lm.tree_leaves(tstate.error):
            np.testing.assert_allclose(a.numpy(), _jax_at(jstate.error, path),
                                       rtol=0, atol=1e-7)
    assert compress.compressed_bytes(ts.params) == \
        jcompress.compressed_bytes(js.params)


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_hosts,host_id",
                         [("qwen3-8b", 1, 0), ("qwen3-8b", 2, 1),
                          ("musicgen-medium", 2, 0)])
def test_token_batches_are_jax_bytes(arch, n_hosts, host_id):
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    kw = dict(vocab=jc.vocab, seq_len=24, global_batch=6, seed=3,
              n_hosts=n_hosts, host_id=host_id)
    want = jdata.token_batches(jdata.DataConfig(**kw), jc, start_step=4)
    got = data.token_batches(data.DataConfig(**kw), tc, start_step=4)
    for _ in range(3):
        w, g = next(want), next(got)
        assert sorted(w) == sorted(g)
        assert ("frontend_embed" in g) == bool(tc.frontend)
        for k in w:
            assert w[k].dtype == g[k].dtype and w[k].shape == g[k].shape
            assert w[k].tobytes() == g[k].tobytes()


def test_image_batches_are_jax_bytes():
    want = jdata.image_batches(3, 8, 3, 10, seed=2)
    got = data.image_batches(3, 8, 3, 10, seed=2)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in ("images", "labels"):
            assert w[k].dtype == g[k].dtype
            assert w[k].tobytes() == g[k].tobytes()
