"""The port's LM serving path (``train/steps.py``'s serving half and
``launch/serve.py``) against the JAX package, on the CPU.

``generate`` must give JAX's greedy tokens for the same parameters (JAX's
``init_params`` carried across) and prompts (numpy, from a seed), fp32
smoke configs, one from each family that serves differently. The port's
copy of ``tests/test_archs.py::test_prefill_then_decode_matches_forward``
runs on the port's own seeded parameters, with that test's tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.train import steps


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b", "xlstm-125m"])
def test_prefill_then_decode_matches_forward(arch):
    """Prefill+decode must agree with teacher-forced forward argmax."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    B, S = 2, 16
    g = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, g, "cpu")
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)

    last_fwd = lm.forward(params, toks, cfg)[:, -1]
    logits_pf, cache = lm.prefill(params, toks, cfg, s_max=S + 8)
    np.testing.assert_allclose(logits_pf[:, 0].numpy(), last_fwd.numpy(),
                               rtol=2e-3, atol=2e-3)

    # decode one token and compare against forward on the extended sequence
    nxt = (last_fwd.argmax(-1)[:, None] % cfg.vocab)
    logits_dec, _ = lm.decode_step(params, nxt, cache, cfg)
    logits_fwd2 = lm.forward(params, torch.cat([toks, nxt], 1), cfg)
    np.testing.assert_allclose(logits_dec[:, 0].numpy(),
                               logits_fwd2[:, -1].numpy(),
                               rtol=5e-3, atol=5e-3)


def _serve_cfgs(arch):
    """JAX's and the port's smoke config as the launchers serve them (a
    frontend stripped, as both ``main``s do)."""
    jc, tc = jax_get_config(arch).smoke(), get_config(arch).smoke()
    if jc.frontend:
        jc = dataclasses.replace(jc, frontend=None, frontend_len=0)
        tc = dataclasses.replace(tc, frontend=None, frontend_len=0)
    return jc, tc


@pytest.mark.parametrize("arch", ["qwen3-8b", "dbrx-132b", "zamba2-1.2b",
                                  "xlstm-125m", "musicgen-medium"])
def test_generate_gives_jax_greedy_tokens(arch):
    jc, tc = _serve_cfgs(arch)
    p_j = jlm.init_params(jax.random.key(0), jc)
    p_t = lm.params_from_jax(jax.tree.map(np.asarray, p_j), "cpu")
    prompts = np.random.default_rng(1).integers(0, jc.vocab, (3, 12))
    want = jserve.generate(p_j, jnp.asarray(prompts, jnp.int32), jc, 6, 26)
    got = serve.generate(p_t, torch.from_numpy(prompts), tc, 6, 26)
    assert got.shape == (3, 18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_steps_match_jax():
    """serve_prefill/serve_decode: the same ids as JAX's, logits within
    1e-4, on a config whose vocab is padded (500 -> 512)."""
    jc, tc = _serve_cfgs("qwen3-8b")
    jc = dataclasses.replace(jc, vocab=500)
    tc = dataclasses.replace(tc, vocab=500)
    p_j = jlm.init_params(jax.random.key(2), jc)
    p_t = lm.params_from_jax(jax.tree.map(np.asarray, p_j), "cpu")
    toks = np.random.default_rng(3).integers(0, 500, (2, 9))
    ids_j, lg_j, c_j = jsteps.serve_prefill(p_j, {"tokens": jnp.asarray(
        toks, jnp.int32)}, jc, 16)
    ids_t, lg_t, c_t = steps.serve_prefill(p_t, {"tokens": torch.from_numpy(
        toks)}, tc, 16)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-4,
                               atol=1e-4)
    ids_j, lg_j, _ = jsteps.serve_decode(p_j, ids_j, c_j, jc)
    ids_t, lg_t, _ = steps.serve_decode(p_t, ids_t, c_t, tc)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_never_picks_a_padded_column(dtype):
    """The padded vocab columns get -1e30 in the logits' dtype (bf16 stays
    bf16, as JAX's weakly typed mask keeps it) and lose the argmax even
    where they hold the largest logit; ties take the first maximum."""
    cfg = dataclasses.replace(get_config("qwen3-8b").smoke(), vocab=500)
    logits = torch.zeros((2, 1, 512), dtype=dtype)
    logits[:, :, 500:] = 50.0
    logits[1, 0, 7] = logits[1, 0, 9] = 3.0
    assert steps._greedy(logits, cfg).tolist() == [[0], [7]]
    mask_dtype = []
    real_argmax = torch.argmax

    def spy(x, dim):
        mask_dtype.append(x.dtype)
        return real_argmax(x, dim=dim)
    torch.argmax = spy
    try:
        steps._greedy(logits, cfg)
    finally:
        torch.argmax = real_argmax
    assert mask_dtype == [dtype]


@pytest.mark.parametrize("arch", ["qwen3-8b", "internvl2-26b"])
def test_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch}: generated (2, 12)" in out
    assert "tok/s" in out and " on " not in out.splitlines()[0]
    sample = eval(out.splitlines()[1].split(":", 1)[1])
    assert len(sample) == 4 and all(0 <= t < 512 for t in sample)


def test_cli_refuses_a_full_size_frontend_config():
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "musicgen-medium", "--device", "cpu"])
    assert e.value.code == 2


def test_entry_points_without_a_device_raise(monkeypatch):
    """Like the port's other entry points, the LM's run on the CUDA device
    unless given another, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-8b").smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])
    cache = lm.init_decode_cache(cfg, 1, 8, "cpu")
    assert cache.kv.k.shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                cfg.d_head)
