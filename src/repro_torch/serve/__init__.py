"""Serving: request queues, the fault model, the fleet engine (dp/pp/
hybrid on one card) and latency reports."""
from repro_torch.serve.engine import (SERVE_COUNTERS, ServeEngine,
                                      params_nbytes, restore_latency_model)
from repro_torch.serve.faults import FaultEvent, FaultSchedule
from repro_torch.serve.report import (FleetReport, fleet_report,
                                      latency_report, nearest_rank)
from repro_torch.serve.router import Completion, MicroBatcher, Request, Router

__all__ = ["Completion", "FaultEvent", "FaultSchedule", "FleetReport",
           "MicroBatcher", "Request", "Router", "SERVE_COUNTERS",
           "ServeEngine", "fleet_report", "latency_report", "nearest_rank",
           "params_nbytes", "restore_latency_model"]
