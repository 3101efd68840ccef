"""Seeded fault injection for the elastic runtime.

Two halves, mirroring where faults strike:

- :mod:`repro_torch.chaos.faults` — *fleet* faults: correlated rack failures,
  flapping nodes, slow-then-dead stragglers, WAN brownouts, and seeded
  event-storm generators.  Everything lowers onto the typed events in
  ``runtime.events`` (``apply_event`` is untouched) and round-trips
  through JSON so a storm that broke the controller ships as a fixture.
- :mod:`repro_torch.chaos.inject` — *infrastructure* faults: deterministic
  injection at the three state-bearing seams (planner calls, migration
  transfers, checkpoint writes) via :class:`ChaosConfig` /
  :class:`FaultInjector`.

``HarpConfig.chaos = None`` (the default) keeps every seam fault-free and
the controller bit-identical to the unchaosed runtime.
"""
from repro_torch.chaos.faults import (
    chaos_storm, correlated_failure, event_from_dict, event_to_dict,
    flapping_node, slow_then_dead, trace_from_json, trace_to_json,
    wan_brownout,
)
from repro_torch.chaos.inject import ChaosConfig, FaultInjector

__all__ = [
    "ChaosConfig", "FaultInjector", "chaos_storm", "correlated_failure",
    "event_from_dict", "event_to_dict", "flapping_node", "slow_then_dead",
    "trace_from_json", "trace_to_json", "wan_brownout",
]
