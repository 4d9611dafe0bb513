"""Static verification of the port's plans, specs and artifacts.

The paper's toolflow proves a kernel configuration fits the FPGA before
synthesis; :mod:`repro_torch.analysis.plans` is that pre-flight for the
CUDA kernels: it re-proves a committed ``PlanTable`` or ``CompiledCNN.save``
artifact (shared memory, tile and split geometry, spec consistency,
fusion-group coverage, measured-record joins) without running a kernel.
Findings carry the JAX package's stable ``RPA<nnn>`` codes
(:data:`~repro_torch.analysis.findings.CODES`).
"""
from repro_torch.analysis.findings import (CODES, Finding, baseline_doc,
                                           load_baseline, report_doc)
from repro_torch.analysis.plans import (verify_artifact, verify_compiled,
                                        verify_plan_table)

__all__ = ["CODES", "Finding", "baseline_doc", "load_baseline",
           "report_doc", "verify_artifact", "verify_compiled",
           "verify_plan_table"]
