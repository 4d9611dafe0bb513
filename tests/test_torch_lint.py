"""The port's determinism and contract lint and its CLI against the JAX
package's (``tests/test_analysis.py``'s lint tests, mirrored).

On JAX's synthetic modules the port's ``lint_source`` gives JAX's
findings exactly: codes, lines, messages and snippets. The one rule text
that differs is RPA103's torch clause (torch's global RNG), held here on
its own cases. ``python -m repro_torch.analysis`` keeps JAX's exit codes
and report document, and the whole port, examples included, lints clean
against an empty baseline.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro.analysis.__main__ import main as jax_main
from repro_torch.analysis import (Finding, baseline_doc, lint_source,
                                  load_baseline, report_doc, run_lint)
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.analysis.findings import split_baseline
from repro_torch.analysis.lint import check_api_snapshots
from repro_torch.obs import validate_analysis

REPO = Path(__file__).resolve().parents[1]
BASELINE = REPO / "src" / "repro_torch" / "analysis" / "baseline.json"

SYNTHETIC_BAD = textwrap.dedent("""\
    import json
    import time
    import random
    import numpy as np

    _CACHE = {}

    def cache_key(spec):
        return hash(str(spec))            # RPA101: the PR 9 bug class

    def jitter():
        return np.random.rand() + random.random()   # RPA103 x2

    def stamp():
        return time.time()                # RPA102

    def save(doc, path, extras=[]):       # RPA202
        with open(path, "w") as f:
            f.write(json.dumps(doc))      # RPA104
""")

SHIM = textwrap.dedent("""\
    from repro.models.cnn import cnn_forward
    __all__ = ["run", "ghost"]

    def run(params, x, cfg):
        return cnn_forward(params, x, cfg)
""")

# more of JAX's rule surface: aliases, default_rng, datetime, sort_keys
ALIASES = textwrap.dedent("""\
    import time as _t
    import datetime
    import json as J
    from time import perf_counter
    from numpy.random import default_rng
    import numpy as np

    def f(doc, d=dict(), *, e={1}):
        a = _t.monotonic() + perf_counter()
        b = datetime.datetime.now()
        r = default_rng()
        ok = np.random.default_rng(0)
        s = np.random.SeedSequence(3)
        J.dump(doc, open("x", "w"), sort_keys=False)
        J.dumps(doc, sort_keys=True)
        return a, b, r, ok, s
""")

JAX_SOURCES = {"synthetic/bad.py": SYNTHETIC_BAD,
               "synthetic/shim.py": SHIM,
               "synthetic/aliases.py": ALIASES,
               "obs/profiler.py": "import time\nt = time.perf_counter()\n"}


def _dicts(findings):
    return [f.to_dict() for f in findings]


@pytest.mark.parametrize("rel", sorted(JAX_SOURCES))
def test_port_lint_gives_jax_findings(rel):
    src = JAX_SOURCES[rel]
    got = lint_source(src, rel)
    assert _dicts(got) == _dicts(jlint.lint_source(src, rel))
    if rel == "obs/profiler.py":
        assert got == []        # the stopwatch is exempt by path


def test_lint_flags_synthetic_module():
    findings = lint_source(SYNTHETIC_BAD, "synthetic/bad.py")
    codes = {f.code for f in findings}
    assert {"RPA101", "RPA102", "RPA103", "RPA104", "RPA202"} <= codes
    assert sum(f.code == "RPA103" for f in findings) == 2
    f = next(f for f in findings if f.code == "RPA101")
    assert f.path == "synthetic/bad.py" and f.line == 9
    assert "hash" in f.snippet


def test_lint_flags_shims_and_all_drift():
    findings = lint_source(SHIM, "synthetic/shim.py")
    assert any(f.code == "RPA201" and "cnn_forward" in f.message
               for f in findings)
    assert any(f.code == "RPA203" and "ghost" in f.message
               for f in findings)


def test_lint_inline_suppression():
    noisy = "import time\n\ndef stamp():\n    return time.time()\n"
    assert any(f.code == "RPA102" for f in lint_source(noisy, "m.py"))
    quiet = noisy.replace(
        "    return time.time()",
        "    # repro: allow[RPA102] user-facing readout\n"
        "    return time.time()")
    assert lint_source(quiet, "m.py") == []
    same_line = noisy.replace(
        "return time.time()",
        "return time.time()  # repro: allow[RPA102] readout")
    assert lint_source(same_line, "m.py") == []


def test_lint_baseline_is_line_number_insensitive(tmp_path):
    findings = lint_source(SYNTHETIC_BAD, "synthetic/bad.py")
    bl_path = tmp_path / "baseline.json"
    bl_path.write_text(json.dumps(baseline_doc(findings), sort_keys=True))
    baseline = load_baseline(bl_path)
    new, old = split_baseline(findings, baseline)
    assert new == [] and len(old) == len(findings)
    shifted = lint_source("# a comment\n\n" + SYNTHETIC_BAD,
                          "synthetic/bad.py")
    new, old = split_baseline(shifted, baseline)
    assert new == [] and len(old) == len(shifted)


def test_lint_rejects_unknown_baseline_format(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"format": 99, "findings": []}))
    with pytest.raises(ValueError, match="format"):
        load_baseline(p)


# -- RPA103 in the port's idiom: torch's global RNG ---------------------------

TORCH_RNG = [
    ("import torch\nx = torch.randn(3)\n", 1),
    ("import torch\nx = torch.rand(2, 2)\n", 1),
    ("import torch\nx = torch.randint(0, 5, (4,))\n", 1),
    ("import torch\nx = torch.randperm(7)\n", 1),
    ("import torch\nx = torch.normal(0.0, 1.0, (2,))\n", 1),
    ("import torch\nx = torch.bernoulli(torch.ones(2) / 2)\n", 1),
    ("import torch\nx = torch.multinomial(torch.ones(3), 2)\n", 1),
    ("import torch\ntorch.manual_seed(0)\n", 1),
    ("import torch as T\nx = T.randn(3)\n", 1),
    ("from torch import randn\nx = randn(3)\n", 1),
    ("import torch\ng = torch.Generator().manual_seed(0)\n"
     "x = torch.randn(3, generator=g)\n", 0),
    ("import torch\ng = torch.Generator()\ng.manual_seed(1)\n"
     "x = torch.randperm(7, generator=g)\n", 0),
    ("import torch\ng = torch.Generator()\n"
     "x = torch.rand(2, generator=g, device='cpu')\n", 0),
    ("import torch\nx = torch.zeros(3).normal_()\n", 0),
    ("import torch\nx = torch.randn(3)  # repro: allow[RPA103] demo\n", 0),
]


@pytest.mark.parametrize("src,n", TORCH_RNG)
def test_rpa103_flags_torch_global_rng(src, n):
    found = [f for f in lint_source(src, "m.py") if f.code == "RPA103"]
    assert len(found) == n, found
    if n:
        assert found[0].line == src.count("\n")
        assert "torch" in found[0].message
    # JAX's lint has no torch clause: the only rule text that differs
    assert jlint.lint_source(src, "m.py") == []


# -- RPA203's snapshot cross-check -------------------------------------------

def test_snapshot_cross_check_is_clean_on_the_repo():
    assert check_api_snapshots(REPO) == []


def test_snapshot_cross_check_names_drift(tmp_path):
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_api_surface.py").write_text(
        'OPS_SURFACE = {"fc", "gone"}\nPIPELINE_SURFACE = sorted([])\n')
    mod = tmp_path / "src" / "repro_torch" / "kernels"
    mod.mkdir(parents=True)
    (mod / "ops.py").write_text('__all__ = ["fc", "lrn"]\n'
                                'def fc(): pass\ndef lrn(): pass\n')
    found = check_api_snapshots(tmp_path)
    assert [f.code for f in found] == ["RPA203", "RPA203"]
    assert found[0].path == "src/repro_torch/kernels/ops.py"
    assert "['gone']" in found[0].message and "['lrn']" in found[0].message
    assert "cannot cross-check" in found[1].message
    assert found[1].path == "tests/test_torch_api_surface.py"


# -- the whole port ------------------------------------------------------------

def test_port_lint_is_clean():
    """The port, examples included, has no finding and an empty baseline:
    every deliberate wall-clock read carries an inline allow."""
    findings, n_files = run_lint(str(REPO / "src" / "repro_torch"),
                                 repo_root=str(REPO))
    baseline = load_baseline(BASELINE)
    assert baseline == set()
    assert findings == [], "\n".join(str(f) for f in findings)
    assert n_files > 80
    names = {p.name for p in (REPO / "src" / "repro_torch").rglob("*.py")}
    assert {"lint.py", "pipeline.py", "quickstart.py",
            "train_resilient.py"} <= names


def test_lint_imports_nothing_it_scans():
    """A scan of the whole port adds no module to the process: it parses,
    and never imports, what it lints."""
    code = ("import sys; from repro_torch.analysis.lint import run_lint; "
            "before = set(sys.modules); "
            "run_lint('src/repro_torch', repo_root='.'); "
            "print(sorted(set(sys.modules) - before))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src")},
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# -- the CLI -------------------------------------------------------------------

def test_lint_cli_gates_then_baselines(tmp_path):
    root = tmp_path / "pkg"
    root.mkdir()
    (root / "bad.py").write_text(SYNTHETIC_BAD)
    report = tmp_path / "report.json"
    args = ["--lint", "--root", str(root), "--repo-root", str(tmp_path),
            "--json", str(report)]
    rc = analysis_main(args)
    assert rc == 1 == jax_main(args[:-2])
    doc = json.loads(report.read_text())
    assert validate_analysis(doc) == []
    assert doc["tool"] == "repro_torch.analysis"
    assert doc["n_findings"] == 6 and doc["lint"]["files_scanned"] == 1
    findings, _ = run_lint(str(root), repo_root=str(tmp_path))
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps(baseline_doc(findings), sort_keys=True))
    rc = analysis_main(["--lint", "--root", str(root),
                        "--repo-root", str(tmp_path),
                        "--baseline", str(bl), "--json", str(report)])
    assert rc == 0
    doc = json.loads(report.read_text())
    assert validate_analysis(doc) == []
    assert doc["n_findings"] == 0 and doc["n_baselined"] == len(findings)
    assert doc["lint"]["baseline"] == {"path": str(bl), "n_baselined": 6}


def test_cli_unreadable_plan_is_rpa307(tmp_path, capsys):
    bad = tmp_path / "plans.json"
    bad.write_text("{not json")
    report = tmp_path / "r.json"
    assert analysis_main(["--verify-plan", str(bad),
                          "--json", str(report)]) == 1
    doc = json.loads(report.read_text())
    assert validate_analysis(doc) == []
    assert [f["code"] for f in doc["findings"]] == ["RPA307"]
    assert doc["lint"] is None and doc["verify"]["plan_table"] == str(bad)
    assert "verify: 1 finding(s)" in capsys.readouterr().out


def test_cli_verifies_the_ports_artifact_and_plan(tmp_path):
    """A smoke AlexNet compiled on the CPU: its artifact and its saved plan
    table verify clean through the CLI (exit 0)."""
    from repro_torch.configs import get_config
    from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn
    c = compile_cnn(get_config("alexnet").smoke(),
                    ExecutionSpec(serving=Serving(batch=2)), device="cpu")
    c.save(str(tmp_path / "art"))
    c.save_plan(str(tmp_path / "plans.json"))
    report = tmp_path / "r.json"
    assert analysis_main(["--verify-artifact", str(tmp_path / "art"),
                          "--verify-plan", str(tmp_path / "plans.json"),
                          "--json", str(report)]) == 0
    doc = json.loads(report.read_text())
    assert validate_analysis(doc) == [] and doc["n_findings"] == 0


def test_module_entry_point_lints_the_port_clean():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--lint",
         "--baseline", "src/repro_torch/analysis/baseline.json"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src")},
        capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("lint: 0 finding(s), 0 baselined")


def test_report_schema_round_trip():
    f = Finding("RPA301", "plan_table#conv[0]", 0, "over budget")
    doc = report_doc(findings=[f], baselined=[], lint=None,
                     verify={"artifact": None, "plan_table": "t.json",
                             "n_findings": 1})
    assert validate_analysis(doc) == []
    assert validate_analysis(dict(doc, n_findings=7))
    assert validate_analysis(dict(doc, findings=[dict(f.to_dict(),
                                                      code="OOPS")]))
