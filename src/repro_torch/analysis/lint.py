"""The determinism and contract lint: the port's copy of the JAX
package's ``analysis/lint.py``.

An AST pass over ``src/repro_torch`` enforcing the invariants the port
leans on: byte-stable artifacts and checkpoints, a deterministic modelled
clock, and the frozen compile-once API surface. RPA101 is the class of a
real bug in the JAX package (a per-process-salted builtin ``hash()`` in a
measurement cache key).

Determinism (RPA1xx)
  RPA101  builtin ``hash()`` anywhere: its salt changes per process, so
          any key/cache/seed derived from it breaks run-to-run
          determinism. Use ``zlib.crc32`` / sorted JSON.
  RPA102  wall-clock reads (``time.time``/``perf_counter``/``monotonic``,
          ``datetime.now``/``utcnow``/``today``) outside the measurement
          harness (``obs/profiler.py`` is exempt by path: it is the
          stopwatch); everything else rides the modelled clock.
  RPA103  unseeded RNG: the global ``np.random.*`` / stdlib ``random.*``
          state, or a zero-argument ``default_rng()``; and, the port's
          idiom, torch's global RNG: ``torch.rand``/``randn``/``randint``/
          ``randperm``/``normal``/``bernoulli``/``multinomial`` without
          ``generator=``, and ``torch.manual_seed``. Seeded generators
          (``default_rng(seed)``, ``SeedSequence(...)``, a
          ``torch.Generator`` passed as ``generator=``) are fine.
  RPA104  ``json.dump(s)`` without ``sort_keys=True``: unsorted dicts
          make artifact bytes depend on insertion order.

Contracts (RPA2xx)
  RPA201  internal calls to the deprecated shims ``cnn_forward`` /
          ``dump_registry`` / ``set_interpret`` (frozen for external
          callers; new internal code compiles once).
  RPA202  mutable default arguments (list/dict/set literals or calls).
  RPA203  ``__all__`` drift: names declared but not bound at module
          level, plus the ``tests/test_torch_api_surface.py`` snapshot
          sets cross-checked against the module ``__all__`` they pin.

Suppress a deliberate exception inline with
``# repro: allow[RPA102] <why>`` (same line or the line above); park a
legacy finding in ``src/repro_torch/analysis/baseline.json`` (see
``findings.py``). The lint parses source only: it imports none of the
scanned modules, so it cannot launch a kernel or bump a DSE counter.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import (Finding, apply_suppressions,
                                           suppressed_lines)

# Files that ARE the measurement harness: wall-clock reads are their job.
WALLCLOCK_EXEMPT = ("obs/profiler.py",)

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}
# numpy's module-level (globally seeded) distribution functions
_NP_GLOBAL_RNG = {
    "seed", "random", "random_sample", "ranf", "sample", "rand", "randn",
    "randint", "random_integers", "choice", "shuffle", "permutation",
    "bytes", "uniform", "normal", "standard_normal", "exponential",
    "poisson", "binomial", "beta", "gamma", "lognormal",
}
_STDLIB_RNG = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "seed",
}
# torch's module-level (globally seeded) samplers: fine with generator=
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "normal",
              "bernoulli", "multinomial"}
_DEPRECATED_SHIMS = {"cnn_forward", "dump_registry", "set_interpret"}

# API-surface snapshot set -> the module __all__ it pins (repo-relative).
SNAPSHOT_MODULES = {
    "PIPELINE_SURFACE": "src/repro_torch/pipeline/__init__.py",
    "OBS_SURFACE": "src/repro_torch/obs/__init__.py",
    "AUTOTUNE_SURFACE": "src/repro_torch/kernels/autotune.py",
    "OPS_SURFACE": "src/repro_torch/kernels/ops.py",
}
SNAPSHOT_TEST = "tests/test_torch_api_surface.py"


class _Imports:
    """Track import aliases so ``import time as _t; _t.time()`` and
    ``from time import perf_counter`` normalize to dotted names."""

    def __init__(self):
        self.modules: Dict[str, str] = {}   # local name -> module path
        self.names: Dict[str, str] = {}     # local name -> module.attr

    def visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for a in node.names:
                self.modules[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a call target, import-aliases normalized."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = node.id
        if head in self.names:
            head = self.names[head]
        elif head in self.modules:
            head = self.modules[head]
        parts.append(head)
        return ".".join(reversed(parts))


def _norm_np(dotted: str) -> str:
    return dotted.replace("np.random.", "numpy.random.", 1) \
        if dotted.startswith("np.random.") else dotted


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, exempt_wallclock: bool):
        self.rel = rel
        self.exempt_wallclock = exempt_wallclock
        self.imports = _Imports()
        self.findings: List[Finding] = []
        self.src_lines: List[str] = []

    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 0)
        snippet = self.src_lines[line - 1].strip() \
            if 0 < line <= len(self.src_lines) else ""
        self.findings.append(
            Finding(code, self.rel, line, message, snippet))

    # -- imports -----------------------------------------------------------
    def visit_Import(self, node):
        self.imports.visit(node)

    def visit_ImportFrom(self, node):
        self.imports.visit(node)

    # -- calls: the determinism rules + shim calls -------------------------
    def visit_Call(self, node: ast.Call):
        dotted = self.imports.resolve(node.func)
        if dotted:
            dotted = _norm_np(dotted)
            self._check_call(node, dotted)
        self.generic_visit(node)

    def _check_call(self, node: ast.Call, dotted: str) -> None:
        last = dotted.rsplit(".", 1)[-1]
        if dotted == "hash":
            self._emit(
                "RPA101", node,
                "builtin hash() is salted per process — any key/cache/"
                "seed derived from it is non-deterministic across runs; "
                "use zlib.crc32 over sorted-JSON bytes")
        elif dotted in _WALLCLOCK and not self.exempt_wallclock:
            self._emit(
                "RPA102", node,
                f"wall-clock read {dotted}() outside the measurement "
                f"harness — modeled-clock paths must stay deterministic")
        elif dotted.startswith("numpy.random.") \
                and last in _NP_GLOBAL_RNG:
            self._emit(
                "RPA103", node,
                f"numpy global-state RNG {dotted}() — seed an explicit "
                f"np.random.default_rng(seed) instead")
        elif (dotted.endswith("random.default_rng")
              or dotted == "default_rng") and not node.args \
                and not node.keywords:
            self._emit(
                "RPA103", node,
                "default_rng() without a seed draws OS entropy — pass "
                "an explicit seed")
        elif dotted.startswith("random.") and last in _STDLIB_RNG \
                and self.imports.modules.get(
                    dotted.split(".", 1)[0]) == "random":
            self._emit(
                "RPA103", node,
                f"stdlib global-state RNG {dotted}() — use a seeded "
                f"random.Random(seed) or np.random.default_rng(seed)")
        elif (dotted == f"torch.{last}" and last in _TORCH_RNG
              and not any(kw.arg == "generator" for kw in node.keywords)):
            self._emit(
                "RPA103", node,
                f"torch global-state RNG {dotted}() — pass an explicit "
                f"generator=torch.Generator().manual_seed(seed)")
        elif dotted == "torch.manual_seed":
            self._emit(
                "RPA103", node,
                "torch.manual_seed() seeds the global RNG — seed an "
                "explicit torch.Generator and pass it as generator=")
        elif last in ("dump", "dumps") and dotted in (
                "json.dump", "json.dumps"):
            sk = next((kw for kw in node.keywords
                       if kw.arg == "sort_keys"), None)
            explicit_false = sk is not None and isinstance(
                sk.value, ast.Constant) and sk.value.value is False
            if sk is None or explicit_false:
                self._emit(
                    "RPA104", node,
                    f"{dotted}(...) without sort_keys=True — artifact "
                    f"bytes would depend on dict insertion order")
        elif last in _DEPRECATED_SHIMS and (
                dotted == last or dotted.endswith(f".{last}")):
            self._emit(
                "RPA201", node,
                f"internal call to deprecated shim {last}() — frozen "
                f"for external callers only; new code compiles once "
                f"(compile_cnn / interpret_mode)")

    # -- defs: mutable defaults (RPA202) -----------------------------------
    def _check_defaults(self, node) -> None:
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            mutable = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in ("list", "dict", "set"))
            if mutable:
                self._emit(
                    "RPA202", d,
                    f"mutable default argument in {node.name}() — one "
                    f"shared object across every call; default to None "
                    f"(or a tuple) and build inside")

    def visit_FunctionDef(self, node):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node):
        self._check_defaults(node)
        self.generic_visit(node)


def _module_all(tree: ast.Module) -> Optional[List[str]]:
    """The module's ``__all__`` literal, or None if it has none."""
    for node in tree.body:
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "__all__":
                try:
                    return list(ast.literal_eval(node.value))
                except (ValueError, TypeError):
                    return None
    return None


def _module_bindings(tree: ast.Module) -> Set[str]:
    """Names bound at module top level (defs, classes, assigns, imports)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                elif isinstance(t, ast.Tuple):
                    out.update(e.id for e in t.elts
                               if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                if a.name == "*":
                    continue
                out.add(a.asname or a.name.split(".")[0])
    return out


def _check_all_drift(tree: ast.Module, rel: str,
                     findings: List[Finding]) -> None:
    declared = _module_all(tree)
    if declared is None:
        return
    missing = sorted(set(declared) - _module_bindings(tree))
    if missing:
        findings.append(Finding(
            "RPA203", rel, 0,
            f"__all__ declares {missing} but the module never binds "
            f"them at top level"))


def lint_source(source: str, rel: str) -> List[Finding]:
    """Lint one module's source text (the unit the tests drive)."""
    tree = ast.parse(source)
    exempt = any(rel.replace("\\", "/").endswith(e)
                 for e in WALLCLOCK_EXEMPT)
    linter = _Linter(rel, exempt)
    linter.src_lines = source.splitlines()
    linter.visit(tree)
    _check_all_drift(tree, rel, linter.findings)
    return apply_suppressions(linter.findings, suppressed_lines(source))


def lint_file(path, rel: Optional[str] = None) -> List[Finding]:
    path = Path(path)
    return lint_source(path.read_text(), rel or str(path))


def check_api_snapshots(repo_root) -> List[Finding]:
    """Cross-check ``tests/test_torch_api_surface.py``'s pinned surface
    sets against the ``__all__`` of the modules they snapshot — drift in
    either direction is a finding before it is a test failure."""
    repo_root = Path(repo_root)
    snap_path = repo_root / SNAPSHOT_TEST
    findings: List[Finding] = []
    if not snap_path.exists():
        return findings
    tree = ast.parse(snap_path.read_text())
    rel_snap = SNAPSHOT_TEST
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        mod_rel = SNAPSHOT_MODULES.get(name)
        if mod_rel is None:
            continue
        try:
            snapshot = set(ast.literal_eval(node.value))
        except (ValueError, TypeError):
            findings.append(Finding(
                "RPA203", rel_snap, node.lineno,
                f"{name} is not a literal set — cannot cross-check"))
            continue
        mod_path = repo_root / mod_rel
        declared = _module_all(ast.parse(mod_path.read_text()))
        if declared is None:
            findings.append(Finding(
                "RPA203", mod_rel, 0,
                f"{mod_rel} declares no __all__ but {name} pins one"))
            continue
        extra = sorted(snapshot - set(declared))
        missing = sorted(set(declared) - snapshot)
        if extra or missing:
            findings.append(Finding(
                "RPA203", mod_rel, 0,
                f"__all__ drift vs {name}: "
                f"in snapshot only {extra}, in module only {missing}"))
    return findings


def run_lint(root, repo_root=None) -> Tuple[List[Finding], int]:
    """Lint every ``*.py`` under ``root``; returns (findings, n_files).

    ``repo_root`` (when given) additionally enables the API-snapshot
    cross-check and makes finding paths repo-relative.
    """
    root = Path(root)
    files = sorted(root.rglob("*.py"))
    findings: List[Finding] = []
    for f in files:
        if repo_root is not None:
            try:
                rel = str(f.resolve().relative_to(
                    Path(repo_root).resolve()))
            except ValueError:
                rel = str(f)
        else:
            rel = str(f)
        findings.extend(lint_file(f, rel.replace("\\", "/")))
    if repo_root is not None:
        findings.extend(check_api_snapshots(repo_root))
    return findings, len(files)
