"""repro_torch.obs — unified tracing, metrics, and predicted-vs-observed drift
accounting across the planner / runtime / serving stack.

Four pieces (see docs/observability.md):

- :mod:`repro_torch.obs.trace` — typed span model + Chrome-trace/Perfetto
  exporter + adapters over every existing timing artifact (pipesim,
  netsim, migration pricing, serving dispatch, controller decisions);
- :mod:`repro_torch.obs.metrics` — process-local labeled metrics registry with
  deterministic snapshots + shims over the stack's scattered counters;
- :mod:`repro_torch.obs.drift` — predicted-vs-observed ledger and
  :class:`DriftReport` (per-step / per-stage / per-pool relative error);
- :mod:`repro_torch.obs.sink` — schema-versioned JSONL run-log on the sim clock.

``HarpConfig.obs = ObsConfig(...)`` wires it through the facade
(``Executable.trace()``, ``trace_out=`` on simulate/replay/serve_simulate,
drift ledger on the elastic controller); ``obs=None`` (the default) is
bit-identical to the pre-obs stack — pinned in tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

from repro_torch.obs.drift import DriftLedger, DriftReport
from repro_torch.obs.metrics import (DEFAULT_REGISTRY, MetricsRegistry,
                               default_registry, record_decision,
                               record_serve_result, sync_from_injector,
                               sync_from_sim_memo)
from repro_torch.obs.sink import SINK_SCHEMA, RunLog, iter_kind, read_runlog
from repro_torch.obs.trace import (OBS_TRACE_SCHEMA, Counter, Span, Trace,
                             render_ascii, trace_from_decisions,
                             trace_from_migration, trace_from_netsim,
                             trace_from_serve, trace_from_sim,
                             trace_to_chrome)


@dataclass
class ObsConfig:
    """Observability knobs.  All output is opt-in per call site
    (``trace_out=`` / ``run_log``); attaching the config alone never writes
    a file and never changes planning or runtime behavior."""
    run_log: Optional[str] = None       # JSONL run-log path (replay/fit)
    drift_threshold: float = 0.15       # |rel error| that flags a report
    drift_window: int = 8               # observed steps per report window

    def to_dict(self) -> Dict[str, Any]:
        return {"run_log": self.run_log,
                "drift_threshold": self.drift_threshold,
                "drift_window": self.drift_window}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ObsConfig":
        return ObsConfig(
            run_log=d.get("run_log"),
            drift_threshold=d.get("drift_threshold", 0.15),
            drift_window=d.get("drift_window", 8))

    def ledger(self) -> DriftLedger:
        return DriftLedger(threshold=self.drift_threshold,
                           window=self.drift_window)


__all__ = [
    "ObsConfig",
    "OBS_TRACE_SCHEMA", "Span", "Counter", "Trace", "trace_to_chrome",
    "render_ascii", "trace_from_sim", "trace_from_netsim",
    "trace_from_migration", "trace_from_serve", "trace_from_decisions",
    "MetricsRegistry", "DEFAULT_REGISTRY", "default_registry",
    "sync_from_sim_memo", "sync_from_injector", "record_decision",
    "record_serve_result",
    "DriftLedger", "DriftReport",
    "SINK_SCHEMA", "RunLog", "read_runlog", "iter_kind",
]
