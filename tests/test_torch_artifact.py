"""The port's serving artifact (slice 5) against the JAX package's, on the
CPU, at ``alexnet.smoke()`` and ``vgg16.smoke()``.

JAX artifacts are built as ``tests/test_pipeline.py`` builds them (the
JAX package's default spec, ``use_pallas=True``, whose compile runs no
kernel; its reference logits come from ``use_pallas=False``, since the
Pallas conv raises under this jax) and loaded by the port: fp32 logits
within rtol = atol = 1e-4 of JAX's (``tests/test_kernels.py``'s fp32
tolerance), int8 bit for bit, and bf16 (which JAX cannot reload) within
2e-2 x max|logit| on the same bf16 batch. The port's own artifacts
round-trip byte for byte (manifest, plan table and every leaf), their
leaf files equal JAX's for the same parameters, a load runs no sweep, and
an uncommitted or truncated artifact raises ``CheckpointError``. The
commit protocol (``commit_dir``, ``clean_stale_tmp``) leaves the trees
JAX's leaves.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipe
from repro.ckpt import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro_torch.ckpt import CheckpointError, clean_stale_tmp, commit_dir
from repro_torch.configs import get_config
from repro_torch.kernels import autotune
from repro_torch.pipeline import (CompiledCNN, ExecutionSpec, Placement,
                                  Precision, Serving, Tiling, compile_cnn)
from repro_torch.pipeline.artifact import spec_from_dict

FP32 = dict(rtol=1e-4, atol=1e-4)
BF16_RTOL = 2e-2
ARCHS = ["alexnet", "vgg16"]
MODES = {"fp32": {}, "int8": {"quant": "int8"}, "bf16": {"dtype": "bfloat16"}}


def _batch(cfg, n=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.input_hw, cfg.input_hw, cfg.input_ch)).astype(np.float32)


def _jax_compile(arch, mode, *, use_pallas, params=None):
    """JAX's compile of fresh parameters in the mode's dtype (int8:
    calibrated on a batch of 8), or of ``params``."""
    jcfg = jax_get_config(arch).smoke()
    if params is None and mode == "int8":
        params = jnp.asarray(_batch(jcfg, 8, seed=9))
    spec = jpipe.ExecutionSpec(precision=jpipe.Precision(**MODES[mode]),
                               serving=jpipe.Serving(batch=4),
                               use_pallas=use_pallas)
    return jcfg, jpipe.compile_cnn(jcfg, spec, params,
                                   key=jax.random.key(5))


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS
                                        for m in MODES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_artifact(request, tmp_path_factory):
    """Two JAX artifacts of the same parameters, on the oracle path
    (``use_pallas=False``) and with the default spec, and JAX's logits on
    the oracle path."""
    arch, mode = request.param
    jcfg, ref = _jax_compile(arch, mode, use_pallas=False)
    _, default = _jax_compile(arch, mode, use_pallas=True, params=ref.params)
    root = tmp_path_factory.mktemp("jax")
    ref.save(root / "oracle")
    default.save(root / "default")
    x = _batch(jcfg)
    xj = jnp.asarray(x, jnp.bfloat16 if mode == "bf16" else jnp.float32)
    logits = np.asarray(ref.forward(xj).astype(jnp.float32))
    return arch, mode, root, x, logits


def _close(arch, mode, got, want):
    got = got.float().numpy()
    if mode == "int8":
        np.testing.assert_array_equal(got, want)
    elif mode == "fp32":
        np.testing.assert_allclose(got, want, **FP32)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_RTOL * np.abs(want).max(), (arch, err)


def test_jax_artifact_loads_with_jax_logits(jax_artifact):
    """``use_pallas=False`` in the artifact is ``use_kernels=False``: the
    port's oracles against JAX's."""
    arch, mode, root, x, want = jax_artifact
    c = CompiledCNN.load(root / "oracle", device="cpu")
    assert c.quant == (mode == "int8") and not c.spec.use_kernels
    assert c.model.in_dtype == (torch.bfloat16 if mode == "bf16"
                                else torch.float32)
    _close(arch, mode, c.forward(x), want)


def test_default_jax_artifact_loads_on_the_kernels(jax_artifact):
    """The JAX package's default spec (Pallas kernels, TPU tiling) loads
    without a SpecError: the kernels run, the TPU's tiling numbers are
    dropped, and the parameters are the oracle artifact's."""
    arch, mode, root, x, _ = jax_artifact
    c = CompiledCNN.load(root / "default", device="cpu")
    assert c.spec.use_kernels and c.spec.tiling == Tiling()
    assert not any(r["backend"] == "tpu"
                   for r in c.plans().conv + c.plans().gemm)
    oracle = CompiledCNN.load(root / "oracle", device="cpu")
    for a, b in zip(c.model.state_dict().values(),
                    oracle.model.state_dict().values()):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(c.forward(x).float()).all())


def _files(root):
    return {p.name: p.read_bytes() for p in sorted(root.iterdir())}


def test_port_leaves_are_jax_bytes_and_round_trip(jax_artifact, tmp_path):
    """The port's save of JAX's parameters writes JAX's leaf files byte
    for byte; save -> load -> save is byte-stable in every file."""
    arch, mode, root, x, _ = jax_artifact
    path = root / "default"
    c = CompiledCNN.load(path, device="cpu")
    a1, a2 = tmp_path / "a1", tmp_path / "a2"
    c.save(a1)
    jax_files, f1 = _files(path), _files(a1)
    leaves = sorted(k for k in f1 if k.startswith("leaf_"))
    assert leaves == sorted(k for k in jax_files if k.startswith("leaf_"))
    for k in leaves:
        assert f1[k] == jax_files[k], k
    man = json.loads(f1["manifest.json"])
    jman = json.loads(jax_files["manifest.json"])
    assert man["params"] == jman["params"]
    if mode == "bf16":
        assert {m["dtype"] for m in man["params"]["leaves"]} == {"bfloat16"}
        assert b"'descr': '<V2'" in f1[leaves[0]]
    c2 = CompiledCNN.load(a1, device="cpu")
    c2.save(a2)
    assert _files(a2) == f1
    assert torch.equal(c2.forward(x), c.forward(x))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_port_artifact_round_trip_runs_no_sweep(arch, mode, tmp_path):
    cfg = get_config(arch).smoke()
    spec = ExecutionSpec(precision=Precision(**MODES[mode]),
                         placement=Placement(pp_stages=2),
                         serving=Serving(batch=4, retries=1))
    c = compile_cnn(cfg, spec, device="cpu")
    c.save(tmp_path / "a1")
    autotune.clear_registry()
    autotune.reset_sweep_stats()
    c2 = CompiledCNN.load(tmp_path / "a1", device="cpu")
    st = autotune.sweep_stats()
    assert st["conv_sweeps"] == 0 and st["gemm_sweeps"] == 0
    assert st["conv_hits"] > 0 and st["gemm_hits"] > 0
    assert c2.spec == c.spec and c2.cfg == c.cfg
    assert c2.stages == c.stages and c2.engine.n_micro == c.engine.n_micro
    c2.save(tmp_path / "a2")
    assert _files(tmp_path / "a2") == _files(tmp_path / "a1")
    x = _batch(cfg)
    assert torch.equal(c2.forward(x), c.forward(x))


def test_uncommitted_or_truncated_artifact_raises(tmp_path):
    c = compile_cnn(get_config("alexnet").smoke(), device="cpu")
    p = tmp_path / "art"
    c.save(p)
    (p / "_COMMITTED").unlink()
    with pytest.raises(CheckpointError, match="committed"):
        CompiledCNN.load(p, device="cpu")
    (p / "_COMMITTED").write_text("ok")
    (p / "leaf_0.npy").write_bytes(b"\x93NUMPY truncated")
    with pytest.raises(CheckpointError, match="leaf 0"):
        CompiledCNN.load(p, device="cpu")
    c.save(p)
    meta = json.loads((p / "manifest.json").read_text())
    meta["params"]["leaves"][1]["shape"] = [7]
    (p / "manifest.json").write_text(json.dumps(meta))
    with pytest.raises(CheckpointError, match="leaf 1"):
        CompiledCNN.load(p, device="cpu")


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    c = compile_cnn(get_config("alexnet").smoke(), device="cpu")
    c.save(tmp_path / "art")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledCNN.load(tmp_path / "art")


def test_jax_spec_keeps_only_what_the_port_runs():
    spec = jpipe.ExecutionSpec(
        tiling=jpipe.Tiling(vmem_budget=1 << 20, vec_size=4, cu_num=8,
                            oh_blk=2, b_blk=2),
        placement=jpipe.Placement(replicas=2, pp_stages=2, microbatches=2),
        serving=jpipe.Serving(batch=4, retries=2, backoff=0.5, slo=0.1,
                              clock="modeled", execute=False),
        use_pallas=False, interpret=True)
    import dataclasses
    got = spec_from_dict(dataclasses.asdict(spec))
    assert got == ExecutionSpec(
        placement=Placement(replicas=2, pp_stages=2, microbatches=2),
        serving=Serving(batch=4, retries=2, backoff=0.5, slo=0.1,
                        clock="modeled", execute=False),
        use_kernels=False)


def _tree(root):
    return sorted((str(p.relative_to(root)), p.read_bytes() if p.is_file()
                   else None) for p in root.rglob("*"))


def test_commit_protocol_equals_jax(tmp_path):
    def write(d):
        (d / "a.txt").write_text("payload")
        (d / "sub").mkdir()
        (d / "sub" / "b.bin").write_bytes(b"\x00\x01")

    for mod, root in ((jckpt, tmp_path / "jax"), (None, tmp_path / "port")):
        root.mkdir()
        commit = mod.commit_dir if mod else commit_dir
        clean = mod.clean_stale_tmp if mod else clean_stale_tmp
        (root / "art.tmp").mkdir()                 # a crashed writer's
        (root / "art.tmp" / "junk").write_text("x")
        assert commit(root / "art", write) == root / "art"
        assert commit(root / "art", write) == root / "art"   # overwrite
        (root / "old.tmp").mkdir()
        (root / "keep").mkdir()
        (root / "file.tmp").write_text("a file, not a staging dir")
        assert clean(root) == 1
        assert clean(root / "missing") == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "art" / "_COMMITTED").read_text() == "ok"
