"""The port stands alone: no JAX, nothing of the JAX package and no
``ml_dtypes`` (the card's machine has none) in ``src/repro_torch`` (every
subpackage, ``obs/`` and ``analysis/`` included), ``chip_smoke.py`` or
``tile_sweep.py``; ``repro_torch.obs`` stands below the serving stack;
and no silent CPU fallback."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.pipeline import ExecutionSpec, Precision, compile_cnn

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tile_sweep.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_leaves_jax_out():
    code = ("import pkgutil, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    __import__(m.name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


@pytest.mark.parametrize("package,banned", [
    ("repro_torch.obs", "repro_torch.serve"),
    ("repro_torch.obs", "repro_torch.pipeline"),
    ("repro_torch.obs.validate", "repro_torch.")],
    ids=["obs_without_serve", "obs_without_pipeline", "validate_alone"])
def test_obs_stands_below_the_serving_stack(package, banned):
    """The serving loops import ``repro_torch.obs``, never the reverse:
    ``obs`` imports nothing of ``repro_torch.serve`` (nor the pipeline),
    and the validator imports nothing of the port but its own package."""
    code = (f"import sys, {package}\n"
            f"bad = sorted(m for m in sys.modules if m.startswith("
            f"{banned!r}) and not m.startswith('repro_torch.obs'))\n"
            f"assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


def test_compile_without_cuda_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_cnn(get_config("alexnet").smoke())


def test_int8_compile_without_cuda_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_cnn(get_config("alexnet").smoke(),
                    ExecutionSpec(precision=Precision(quant="int8")))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    run = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout == ""
