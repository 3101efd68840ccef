"""Elastic runtime orchestration: the offline HAPT planner closed into an
event-driven loop (events -> telemetry -> controller -> replay).  See
DESIGN.md §4."""
from repro_torch.runtime.controller import (
    ControllerConfig, ElasticController, ReplanDecision,
)
from repro_torch.runtime.events import (
    BandwidthShift, ClusterEvent, EventTrace, NodeFailure, NodeJoin,
    Preemption, Straggler, apply_event, paper_trace, random_trace,
)
from repro_torch.runtime.replay import (
    ReplayResult, ReplaySample, feasible_under, project_step, run_replay,
)
from repro_torch.runtime.telemetry import StepObservation, TelemetryCalibrator

__all__ = [
    "ClusterEvent", "NodeFailure", "NodeJoin", "BandwidthShift", "Straggler",
    "Preemption", "EventTrace", "apply_event", "paper_trace", "random_trace",
    "TelemetryCalibrator", "StepObservation",
    "ElasticController", "ControllerConfig", "ReplanDecision",
    "run_replay", "ReplayResult", "ReplaySample", "project_step",
    "feasible_under",
]
