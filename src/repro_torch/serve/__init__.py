"""Serving: request queue, gang-round engine and latency reports."""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.report import (FleetReport, fleet_report,
                                      latency_report, nearest_rank)
from repro_torch.serve.router import Completion, MicroBatcher, Request, Router

__all__ = ["Completion", "FleetReport", "MicroBatcher", "Request", "Router",
           "ServeEngine", "fleet_report", "latency_report", "nearest_rank"]
