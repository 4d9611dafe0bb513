"""Finding records, baselines and the analysis report document.

The port's copy of the JAX package's ``analysis/findings.py``. Every
problem the static analysis proves is a :class:`Finding` with a stable
``RPA<nnn>`` code (the JAX package's numbers), a locator and a message.
This module is the bookkeeping the verifier
(:mod:`repro_torch.analysis.plans`) reports through:

* inline suppressions: ``# repro: allow[RPA101] <reason>`` on the flagged
  line or the line above it;
* a committed **baseline** of known findings, keyed by ``(code, path,
  stripped source line)`` and not by line number, so edits that shift
  code do not bring a baselined finding back;
* the JSON report document, which
  :func:`repro_torch.obs.validate.validate_analysis` schema-checks.
"""
from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

REPORT_FORMAT = 1
TOOL = "repro_torch.analysis"

# RPA = Repro Pipeline Analysis. 1xx determinism, 2xx contracts,
# 3xx artifact/plan verification; the JAX package's numbers, append-only (a
# retired rule keeps its number). The port's 301-303 prove the CUDA
# kernels' shared memory and tiles where the JAX package proves VMEM and
# Pallas blocks.
CODES: Dict[str, str] = {
    "RPA101": "builtin hash() in a key/cache expression (salted per process)",
    "RPA102": "wall-clock read outside the measurement harness",
    "RPA103": "unseeded RNG (global numpy/stdlib random state)",
    "RPA104": "json.dump(s) without sort_keys on an artifact path",
    "RPA201": "internal call to a deprecated shim",
    "RPA202": "mutable default argument",
    "RPA203": "__all__ drift vs module bindings / API-surface snapshot",
    "RPA300": "malformed plan row (missing/ill-typed field)",
    "RPA301": "plan exceeds its declared shared-memory budget",
    "RPA302": "recorded smem_bytes disagrees with the kernels' table",
    "RPA303": "tile or split does not fit its layer shape",
    "RPA304": "plan inconsistent with the Precision/Tiling spec",
    "RPA305": "stage/fusion-group coverage broken",
    "RPA306": "measured record does not reconcile with its row",
    "RPA307": "artifact structure invalid (manifest/leaves/commit marker)",
}

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[([A-Z0-9,\s]+)\]")


@dataclass(frozen=True)
class Finding:
    """One statically proven problem."""
    code: str                   # stable rule id, e.g. "RPA301"
    path: str                   # repo-relative file (or artifact locator)
    line: int                   # 1-based source line; 0 for non-source
    message: str                # human sentence naming the offender
    snippet: str = ""           # stripped source line (baseline identity)

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity — line-number-insensitive on purpose."""
        return (self.code, self.path, self.snippet)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.code} {self.message}"


def suppressed_lines(source: str) -> Dict[int, Set[str]]:
    """Map 1-based line number -> codes allowed there.

    An ``# repro: allow[...]`` comment covers its own line and the line
    below it (so a suppression can sit above a long statement).
    """
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        out.setdefault(i, set()).update(codes)
        out.setdefault(i + 1, set()).update(codes)
    return out


def apply_suppressions(findings: Iterable[Finding],
                       allowed: Dict[int, Set[str]]) -> List[Finding]:
    return [f for f in findings if f.code not in allowed.get(f.line, ())]


# ---------------------------------------------------------------------------
# Baseline file
# ---------------------------------------------------------------------------

def load_baseline(path) -> Set[Tuple[str, str, str]]:
    """Read a committed baseline into a set of finding keys."""
    doc = json.loads(Path(path).read_text())
    if doc.get("format") != REPORT_FORMAT:
        raise ValueError(
            f"baseline {path}: unknown format {doc.get('format')!r}")
    return {(f["code"], f["path"], f.get("snippet", ""))
            for f in doc.get("findings", [])}


def baseline_doc(findings: Sequence[Finding]) -> dict:
    """The committed-baseline document for the given findings."""
    keys = sorted({f.key() for f in findings})
    return {"format": REPORT_FORMAT,
            "findings": [{"code": c, "path": p, "snippet": s}
                         for c, p, s in keys]}


def split_baseline(findings: Sequence[Finding],
                   baseline: Set[Tuple[str, str, str]]
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(new, baselined) — only ``new`` findings gate."""
    new, old = [], []
    for f in findings:
        (old if f.key() in baseline else new).append(f)
    return new, old


# ---------------------------------------------------------------------------
# The report document (validated by obs.validate.validate_analysis)
# ---------------------------------------------------------------------------

def report_doc(*, findings: Sequence[Finding],
               baselined: Sequence[Finding] = (),
               lint: Optional[dict] = None,
               verify: Optional[dict] = None) -> dict:
    order = lambda f: (f.path, f.line, f.code)  # noqa: E731
    return {
        "tool": TOOL,
        "format": REPORT_FORMAT,
        "n_findings": len(findings),
        "n_baselined": len(baselined),
        "findings": [f.to_dict() for f in sorted(findings, key=order)],
        "baselined": [f.to_dict() for f in sorted(baselined, key=order)],
        "lint": lint,
        "verify": verify,
    }


def dump_report(doc: dict, path) -> None:
    Path(path).write_text(
        json.dumps(doc, sort_keys=True, indent=1) + "\n")
