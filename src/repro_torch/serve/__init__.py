"""Serving: request queues, the fault model, the fleet engine (dp/pp/
hybrid on one card, gang rounds or continuous slots with steals and
autoscaling) and latency reports."""
from repro_torch.serve.engine import (SERVE_COUNTERS, ServeEngine,
                                      params_nbytes, restore_latency_model)
from repro_torch.serve.faults import FaultEvent, FaultSchedule
from repro_torch.serve.report import (FleetReport, fleet_report,
                                      latency_report, nearest_rank)
from repro_torch.serve.router import Completion, MicroBatcher, Request, Router
from repro_torch.serve.scheduler import (AutoscalePolicy,
                                         ContinuousScheduler, ScaleEvent)
from repro_torch.serve.stage_planner import total_cost

__all__ = ["AutoscalePolicy", "Completion", "ContinuousScheduler",
           "FaultEvent", "FaultSchedule", "FleetReport", "MicroBatcher",
           "Request", "Router", "SERVE_COUNTERS", "ScaleEvent",
           "ServeEngine", "fleet_report", "latency_report", "nearest_rank",
           "params_nbytes", "restore_latency_model", "total_cost"]
