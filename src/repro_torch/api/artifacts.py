"""The staged compile artifacts: ``Plan`` -> ``LoweredPlan``.

Both are passive dataclasses with a lossless, *stable* JSON round trip
(``Plan.from_json(p.to_json()).to_json() == p.to_json()`` bit-for-bit — the
CLI subcommands and any cross-machine plan hand-off depend on it; the golden
schema test in ``tests/test_api.py`` pins the field tree).

- :class:`Plan` — the search stage's output: the raw
  :class:`~repro_torch.core.strategy.ParallelStrategy` plus full provenance (arch,
  serialized cluster spec + fingerprint, the :class:`HarpConfig` used, and
  the predicted step simulation) so a plan is auditable and replayable on a
  machine that never saw the planner run.
- :class:`LoweredPlan` — the lowering stage's output: per-stage logical mesh
  axes (what ``parallel.sharding.mesh_from_intra_op`` materializes), integer
  microbatch apportionment across data shards, the scheduler's warm-up
  counts, and the collective plan (per-link activation bytes + per-stage
  intra-op collective traffic).

Units everywhere: times seconds, payloads bytes, batch entries samples.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.cluster import (
    DeviceProfile, HeteroCluster, SubCluster, cluster_from_dict,
    cluster_to_dict,
)
from repro_torch.core.pipesim import SimResult
from repro_torch.core.strategy import ParallelStrategy

from repro_torch.api.config import HarpConfig

SCHEMA_VERSION = 8   # v8: obs subsystem — HarpConfig.obs (tracing /
                     # metrics / drift accounting; None = off, artifacts
                     # bit-identical to v7 apart from this null key)
                     # (v7: chaos subsystem — HarpConfig.chaos (fault
                     # injection; None = off, bit-identical to v6) and
                     # SearchConfig.deadline_s (replan wall-clock budget;
                     # 0.0 = unlimited, the v6 behavior)
                     # v6: kbench subsystem — HarpConfig.kbench /
                     # PlannerConfig.kbench (measured-kernel pricing; None on
                     # analytic plans, which stay bit-identical to v5)
                     # v5: migration subsystem — Plan.migration, the priced
                     # differ summary from Executable.migrate_to / the CLI
                     # `repro migrate`; None on directly-planned artifacts;
                     # v4: serving subsystem — HarpConfig.serving, Plan.serve;
                     # v3: comm subsystem — PlannerConfig.comm, per-stage
                     # collective algorithms, LoweredPlan link occupancy;
                     # v2: SearchConfig gained engine/batch_size knobs)

# Cluster (de)serialization lives in repro_torch.core.cluster (the runtime's plan
# cache and chaos traces need it without importing the api layer); the names
# stay importable from here for artifact consumers.


def sim_summary(res: SimResult, tokens_per_step: int) -> Dict[str, Any]:
    """Compact, JSON-stable digest of a :class:`SimResult` (the full per-node
    start/dur maps are simulation internals, not provenance)."""
    return {
        "makespan_s": res.makespan,
        "throughput_tokens_per_s":
            tokens_per_step / res.makespan if res.makespan else 0.0,
        "overlap_ratio": res.overlap_ratio,
        "comm_total_s": res.comm_total,
        "comm_exposed_s": res.comm_exposed,
        "stage_compute_s": list(res.stage_compute),
        "stage_idle_s": list(res.stage_idle),
        "stage_intra_comm_s": list(res.stage_intra_comm),
        "warmup_counts": list(res.warmup_counts),
    }


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    """Search-stage artifact: strategy + provenance.

    Invariants: ``cluster_fingerprint ==
    cluster_fingerprint(cluster_from_dict(cluster))``; ``config`` is the
    exact :class:`HarpConfig` the search ran with (so ``lower()`` on another
    machine reproduces the same layering and schedule)."""
    arch: str
    strategy: ParallelStrategy
    config: HarpConfig
    cluster: Dict[str, Any]
    cluster_fingerprint: str
    predicted: Dict[str, Any] = field(default_factory=dict)
    serve: Optional[Dict[str, Any]] = None    # ServePlan.to_dict() when the
                                              # config carried a ServingConfig
    migration: Optional[Dict[str, Any]] = None  # priced differ summary when
                                                # this plan was produced by
                                                # migrate_to / `repro migrate`
    version: int = SCHEMA_VERSION

    def to_cluster(self) -> HeteroCluster:
        return cluster_from_dict(self.cluster)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "arch": self.arch,
            "cluster_fingerprint": self.cluster_fingerprint,
            "cluster": self.cluster,
            "config": self.config.to_dict(),
            "strategy": json.loads(self.strategy.to_json()),
            "predicted": self.predicted,
            "serve": self.serve,
            "migration": self.migration,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Plan":
        return Plan(
            arch=d["arch"],
            strategy=ParallelStrategy.from_json(json.dumps(d["strategy"])),
            config=HarpConfig.from_dict(d["config"]),
            cluster=d["cluster"],
            cluster_fingerprint=d["cluster_fingerprint"],
            predicted=d.get("predicted", {}),
            serve=d.get("serve"),       # absent on pre-v4 artifacts
            migration=d.get("migration"),   # absent on pre-v5 artifacts
            version=d.get("version", SCHEMA_VERSION))

    @staticmethod
    def from_json(s: str) -> "Plan":
        return Plan.from_dict(json.loads(s))

    def describe(self) -> str:
        pred = self.predicted.get("throughput_tokens_per_s", 0.0)
        lines = [f"Plan[{self.arch}] on {self.to_cluster().describe()}",
                 f"  predicted {pred:,.0f} tokens/s "
                 f"(scheduler={self.config.scheduler})",
                 self.strategy.describe()]
        if self.serve is not None:
            from repro_torch.serving.placement import ServePlan
            lines.append(ServePlan.from_dict(self.serve).describe())
        if self.migration is not None:
            m = self.migration
            lines.append(
                f"  migrated from {m.get('from_fingerprint', '?')}: "
                f"{m.get('moved_bytes', 0) / 1e6:.0f}MB moved + "
                f"{m.get('ckpt_bytes', 0) / 1e6:.0f}MB restored in "
                f"{m.get('n_transfers', 0)} transfers, "
                f"{m.get('downtime_s', 0.0):.2f}s downtime")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# LoweredPlan
# ---------------------------------------------------------------------------


@dataclass
class StageLowering:
    """One pipeline stage, made executable: the logical mesh layout that
    ``parallel.sharding.mesh_from_intra_op`` materializes, plus the integer
    microbatch split across its data shards (largest-remainder apportionment
    — uneven in mixed sub-clusters, slowest shard first)."""
    stage: int
    subcluster: str
    layer_start: int
    layer_end: int                      # exclusive
    mesh_axes: List[List[Any]]          # [["data", dp], ["model", tp]]
    n_devices: int
    microbatch_shards: List[int]        # per-dp-shard samples, sums to the
                                        # per-microbatch sample count
    intra_comm_bytes: float             # per-microbatch collective payload
    intra_comm_time_s: float            # priced collective time (f+b)
    ar_algorithm: Optional[str] = None  # selected TP all-reduce algorithm
                                        # (None = legacy implicit flat ring)
    sync_algorithm: Optional[str] = None   # ditto, DP gradient sync
    sync_compressed: bool = False       # sync priced int8-block-quantized
    sync_time_s: float = 0.0            # per-step gradient sync (priced)
    sync_link: str = ""                 # physical link the sync occupies


@dataclass
class LoweredPlan:
    """Lowering-stage artifact: meshes + apportionment + schedule +
    collective plan.  ``len(c_links_s) == len(link_bytes) == n_stages - 1``;
    ``len(warmup_counts) == n_stages`` (from the *named* scheduler, not
    necessarily H-1F1B)."""
    scheduler: str
    n_microbatches: int
    microbatch_samples: int             # batch rows per microbatch
    warmup_counts: List[int]
    c_links_s: List[float]              # per-link activation transfer time
    link_bytes: List[float]             # per-link activation payload
    stages: List[StageLowering]
    est_step_time_s: float
    link_ids: List[str] = field(default_factory=list)
    # physical link per stage boundary ("wan" = the shared cross-cluster
    # link; equal ids contend in the netsim / contention simulation)
    link_occupancy_s: Dict[str, float] = field(default_factory=dict)
    # per physical link: priced busy seconds over one step (activation
    # sends both directions + TP all-reduces + gradient syncs)
    contended_links: List[str] = field(default_factory=list)
    # links with more than one collective/boundary charged to them
    version: int = SCHEMA_VERSION

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return {"version": d.pop("version"), **d}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LoweredPlan":
        d = dict(d)
        d["stages"] = [StageLowering(**s) for s in d["stages"]]
        return LoweredPlan(**d)

    @staticmethod
    def from_json(s: str) -> "LoweredPlan":
        return LoweredPlan.from_dict(json.loads(s))

    def describe(self) -> str:
        lines = [f"LoweredPlan: {self.n_stages} stages, "
                 f"scheduler={self.scheduler}, B={self.n_microbatches}, "
                 f"est step {self.est_step_time_s * 1e3:.1f} ms"]
        for s in self.stages:
            axes = "x".join(f"{n}={sz}" for n, sz in s.mesh_axes)
            algo = ""
            if s.sync_algorithm:
                algo = f" sync={s.sync_algorithm}"
                if s.sync_compressed:
                    algo += "+int8"
            lines.append(
                f"  stage{s.stage}: layers[{s.layer_start}:{s.layer_end}] "
                f"on {s.subcluster} mesh({axes}) shards={s.microbatch_shards} "
                f"N={self.warmup_counts[s.stage]}{algo}")
        if self.contended_links:
            lines.append(f"  contended links: {', '.join(self.contended_links)}")
        return "\n".join(lines)
