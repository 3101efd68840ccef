"""``repro_torch.api`` — the staged plan -> lower -> execute compile pipeline.

Counterpart of ``repro/api``: one facade over the whole system.

    from repro_torch import api
    from repro_torch.core.cluster import paper_case_study_cluster

    exe = api.compile("gpt-2b", paper_case_study_cluster(),
                      api.HarpConfig(global_batch=64))
    print(exe.describe())
    res = exe.simulate()              # referee-priced discrete-event step
    exe.attach_elastic()              # elastic controller + telemetry hooks
    exe.fit()                         # fault-tolerant training loop (cuda)

Every stage artifact (:class:`Plan`, :class:`LoweredPlan`) JSON round-trips
bit-identically, and byte-identically with the reference's, so
``python -m repro plan`` on a planning box feeds
``python -m repro_torch train`` on the card.  Pluggable components
(schedulers, cost models, event sources, canonical clusters) are selected by
name through :mod:`repro_torch.api.registry`.
"""
from repro_torch.api.artifacts import (
    LoweredPlan, Plan, StageLowering, cluster_from_dict, cluster_to_dict,
    sim_summary,
)
from repro_torch.api.config import HarpConfig
from repro_torch.api.facade import (
    Executable, compile, fit, generate, lower, plan, warn_deprecated,
)
from repro_torch.api import registry
from repro_torch.chaos import ChaosConfig, FaultInjector
from repro_torch.kbench import KBenchConfig, KBenchModel, LatencyTable
from repro_torch.migrate import MigrationCost, MigrationPlan
from repro_torch.obs import (
    DriftLedger, DriftReport, MetricsRegistry, ObsConfig, RunLog, Trace,
)
from repro_torch.serving.batching import ServeSimResult
from repro_torch.serving.placement import ServePlan, ServingConfig
from repro_torch.serving.workload import ServeTrace

__all__ = [
    "HarpConfig", "Plan", "LoweredPlan", "StageLowering", "Executable",
    "compile", "plan", "lower", "fit", "generate",
    "ServingConfig", "ServePlan", "ServeTrace", "ServeSimResult",
    "MigrationPlan", "MigrationCost",
    "KBenchConfig", "KBenchModel", "LatencyTable",
    "ChaosConfig", "FaultInjector",
    "ObsConfig", "Trace", "DriftLedger", "DriftReport", "MetricsRegistry",
    "RunLog",
    "cluster_to_dict", "cluster_from_dict", "sim_summary",
    "registry", "warn_deprecated",
]
