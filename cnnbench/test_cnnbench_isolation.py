"""What the benchmark may import and read.

* No module under ``cnnbench/`` imports JAX, jaxlib, flax or the JAX
  package ``repro``; names are compared by their top-level part whole,
  since the port's name, ``repro_torch``, begins with ``repro``.
* The reference imports nothing of the port, not even through the
  benchmark's modules it imports.
* Nothing under ``cnnbench/`` reads the JAX package's benchmark
  (``benchmarks/``, ``BENCH_conv.json``).
"""
import ast
from pathlib import Path

import pytest

from cnnbench import run

HERE = Path(__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imports(path: Path):
    """Top-level names and whole dotted names a file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in imports(path)}
    assert not tops & FORBIDDEN, f"{path.name} imports {tops & FORBIDDEN}"


def test_the_reference_imports_nothing_of_the_port():
    seen, todo = set(), ["reference"]
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        names = imports(HERE / f"{mod}.py")
        assert not any(n.split(".")[0].startswith("repro") for n in names), \
            f"cnnbench/{mod}.py imports the program"
        todo += [n.split(".")[1] for n in names
                 if n.startswith("cnnbench.") and n.count(".") == 1
                 and (HERE / f"{n.split('.')[1]}.py").is_file()]
    assert "config" in seen


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.name != Path(__file__).name],
    ids=lambda p: p.name)
def test_nothing_reads_the_jax_packages_benchmark(path):
    text = path.read_text()
    assert "BENCH_conv" not in text and "benchmarks" not in text


def test_the_run_refuses_loaded_jax_by_whole_top_level_name():
    ok = ["torch", "repro_torch", "repro_torch.kernels.conv_pipe",
          "reprox", "numpy"]
    assert run.loaded_forbidden(ok) == []
    assert run.loaded_forbidden(ok + ["repro.kernels", "jaxlib.xla"]) == \
        ["jaxlib", "repro"]
