"""``python -m repro_torch.analysis``: the port's static-analysis gate.

Runs either or both heads and exits nonzero on any non-baseline
finding:

    # determinism & contract lint over the port's source tree
    python -m repro_torch.analysis --lint \
        --baseline src/repro_torch/analysis/baseline.json

    # statically verify a committed artifact / bare plan table
    python -m repro_torch.analysis --verify-artifact artifacts/alexnet_int8
    python -m repro_torch.analysis --verify-plan plans.json

    # machine-readable report (schema: obs.validate.validate_analysis)
    python -m repro_torch.analysis --lint --json analysis_report.json

With no head selected, ``--lint`` is implied. The port's copy of the JAX
package's ``analysis/__main__.py``: the same flags, exit codes and report.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from repro_torch.analysis.findings import (Finding, dump_report,
                                           load_baseline, report_doc,
                                           split_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verifier: plan/artifact feasibility (Head 1)"
                    " + determinism/contract lint (Head 2).")
    ap.add_argument("--lint", action="store_true",
                    help="run the determinism & contract lint")
    ap.add_argument("--root", default="src/repro_torch",
                    help="source tree the lint scans "
                         "(default: src/repro_torch)")
    ap.add_argument("--repo-root", default=".",
                    help="repo root for relative paths + API-snapshot "
                         "cross-check (default: .)")
    ap.add_argument("--baseline", default=None,
                    help="committed baseline JSON; matching findings "
                         "are reported but do not gate")
    ap.add_argument("--verify-artifact", default=None, metavar="DIR",
                    help="statically verify a CompiledCNN.save artifact")
    ap.add_argument("--verify-plan", default=None, metavar="PATH",
                    help="statically verify a bare PlanTable JSON")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON report here")
    args = ap.parse_args(argv)

    run_verify = args.verify_artifact or args.verify_plan
    run_lint_head = args.lint or not run_verify

    findings: List[Finding] = []
    lint_meta = verify_meta = None
    if run_lint_head:
        from repro_torch.analysis.lint import run_lint
        lint_findings, n_files = run_lint(args.root,
                                          repo_root=args.repo_root)
        findings.extend(lint_findings)
        lint_meta = {"root": args.root, "files_scanned": n_files,
                     "n_findings": len(lint_findings)}
    if run_verify:
        verify_findings: List[Finding] = []
        if args.verify_artifact:
            from repro_torch.analysis.plans import verify_artifact
            verify_findings.extend(verify_artifact(args.verify_artifact))
        if args.verify_plan:
            from repro_torch.analysis.plans import verify_plan_table
            from repro_torch.pipeline.plan_table import PlanTable
            try:
                table = PlanTable.from_json(
                    Path(args.verify_plan).read_text())
            except (OSError, ValueError) as e:
                verify_findings.append(Finding(
                    "RPA307", args.verify_plan, 0,
                    f"plan table unreadable: {e}"))
            else:
                verify_findings.extend(
                    verify_plan_table(table, path=args.verify_plan))
        findings.extend(verify_findings)
        verify_meta = {"artifact": args.verify_artifact,
                       "plan_table": args.verify_plan,
                       "n_findings": len(verify_findings)}

    baselined: List[Finding] = []
    if args.baseline:
        baseline = load_baseline(args.baseline)
        findings, baselined = split_baseline(findings, baseline)
        if lint_meta is not None:
            lint_meta["baseline"] = {"path": args.baseline,
                                     "n_baselined": len(baselined)}

    doc = report_doc(findings=findings, baselined=baselined,
                     lint=lint_meta, verify=verify_meta)
    if args.json:
        dump_report(doc, args.json)

    for f in findings:
        print(f"[repro_torch.analysis] {f}")
    heads = " + ".join(h for h, on in (("lint", run_lint_head),
                                       ("verify", run_verify)) if on)
    print(f"[repro_torch.analysis] {heads}: {len(findings)} finding(s)"
          + (f", {len(baselined)} baselined" if args.baseline else ""))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
