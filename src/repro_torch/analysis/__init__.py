"""Static verification of the port's plans, specs, artifacts and source.

The paper's toolflow proves a kernel configuration fits the FPGA before
synthesis; this package is that pre-flight for the CUDA kernels, with two
heads behind one CLI (``python -m repro_torch.analysis``):

* the artifact verifier (:mod:`repro_torch.analysis.plans`) re-proves a
  committed ``PlanTable`` or ``CompiledCNN.save`` artifact (shared memory,
  tile and split geometry, spec consistency, fusion-group coverage,
  measured-record joins) without running a kernel;
* the determinism and contract lint (:mod:`repro_torch.analysis.lint`) is
  an AST pass over the port's source for the bug classes that break
  byte-stable artifacts and the modelled clock (RPA1xx) or the frozen API
  contracts (RPA2xx).

Findings carry the JAX package's stable ``RPA<nnn>`` codes
(:data:`~repro_torch.analysis.findings.CODES`).
"""
from repro_torch.analysis.findings import (CODES, Finding, baseline_doc,
                                           load_baseline, report_doc)
from repro_torch.analysis.lint import (check_api_snapshots, lint_file,
                                       lint_source, run_lint)
from repro_torch.analysis.plans import (verify_artifact, verify_compiled,
                                        verify_plan_table)

__all__ = ["CODES", "Finding", "baseline_doc", "check_api_snapshots",
           "lint_file", "lint_source", "load_baseline", "report_doc",
           "run_lint", "verify_artifact", "verify_compiled",
           "verify_plan_table"]
