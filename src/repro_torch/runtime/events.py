"""Typed cluster-event model for the elastic runtime.

Real heterogeneous fleets are dynamic: nodes fail, spot instances preempt,
cross-cluster bandwidth fluctuates, stragglers emerge.  Each condition change
is a frozen event dataclass; ``apply_event`` folds an event into the (frozen)
:class:`HeteroCluster` value via the ``core.cluster`` mutation helpers, so
fleet history is a pure left-fold over the event stream.

Traces come in two flavors: deterministic *scripted* traces (regression /
benchmark fixtures, e.g. :func:`paper_trace`) and *seeded generators*
(:func:`random_trace`) for fleet-dynamics sweeps.  Both yield an
:class:`EventTrace` — events sorted by the training step at which they strike.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.cluster import (
    GBPS, HeteroCluster, SubCluster, add_nodes, remove_nodes, set_efficiency,
    with_cross_bw,
)


@dataclass(frozen=True)
class ClusterEvent:
    """Base: something changed in the fleet at training step ``step``."""
    step: int

    def describe(self) -> str:
        return f"{type(self).__name__}@{self.step}"


@dataclass(frozen=True)
class NodeFailure(ClusterEvent):
    subcluster: str = ""
    n_nodes: int = 1

    def describe(self) -> str:
        return f"NodeFailure@{self.step}({self.subcluster} -{self.n_nodes})"


@dataclass(frozen=True)
class NodeJoin(ClusterEvent):
    """A node (re)joins — recovery after failure, or elastic scale-up.
    ``template`` re-attaches a sub-cluster that left the fleet entirely
    (its name no longer resolves): the joined nodes take its profile."""
    subcluster: str = ""
    n_nodes: int = 1
    template: Optional["SubCluster"] = None

    def describe(self) -> str:
        return f"NodeJoin@{self.step}({self.subcluster} +{self.n_nodes})"


@dataclass(frozen=True)
class BandwidthShift(ClusterEvent):
    """Cross-cluster link congestion / recovery (absolute new bytes/s)."""
    cross_bw: float = 0.0

    def describe(self) -> str:
        return f"BandwidthShift@{self.step}({self.cross_bw * 8 / 1e9:.1f} Gbps)"


@dataclass(frozen=True)
class Straggler(ClusterEvent):
    """A sub-cluster slows down: its devices' calibrated efficiency becomes
    ``efficiency`` (absolute, e.g. 0.6 = running at 60% of spec)."""
    subcluster: str = ""
    efficiency: float = 1.0

    def describe(self) -> str:
        return f"Straggler@{self.step}({self.subcluster} eff={self.efficiency:.2f})"


@dataclass(frozen=True)
class Preemption(ClusterEvent):
    """Spot-instance reclamation: like a failure, but with advance notice and
    (optionally) a scheduled return after ``duration_steps``.  ``template``
    rides along to the materialized return ``NodeJoin`` so a preemption that
    drains a sub-cluster entirely can re-create the pool from its spec."""
    subcluster: str = ""
    n_nodes: int = 1
    duration_steps: int = 0     # 0 = not coming back
    template: Optional["SubCluster"] = None

    def describe(self) -> str:
        back = f", back in {self.duration_steps}" if self.duration_steps else ""
        return f"Preemption@{self.step}({self.subcluster} -{self.n_nodes}{back})"


def apply_event(cluster: HeteroCluster, event: ClusterEvent) -> HeteroCluster:
    """Pure fold step: new cluster value after ``event``."""
    if isinstance(event, (NodeFailure, Preemption)):
        return remove_nodes(cluster, event.subcluster, event.n_nodes)
    if isinstance(event, NodeJoin):
        names = {s.name for s in cluster.subclusters}
        if event.subcluster not in names and event.template is not None:
            sub = dataclasses.replace(event.template, n_nodes=event.n_nodes)
            return dataclasses.replace(
                cluster, subclusters=cluster.subclusters + (sub,))
        return add_nodes(cluster, event.subcluster, event.n_nodes)
    if isinstance(event, BandwidthShift):
        return with_cross_bw(cluster, event.cross_bw)
    if isinstance(event, Straggler):
        return set_efficiency(cluster, event.subcluster, event.efficiency)
    raise TypeError(f"unknown cluster event {event!r}")


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


@dataclass
class EventTrace:
    """Events sorted by step.  Scheduled returns of ``Preemption`` events are
    materialized as ``NodeJoin`` entries at construction (``materialized=True``
    marks an already-expanded event list — e.g. one deserialized from JSON —
    so re-construction doesn't duplicate the returns)."""
    events: List[ClusterEvent] = field(default_factory=list)
    materialized: bool = False

    def __post_init__(self):
        expanded: List[ClusterEvent] = []
        for e in self.events:
            expanded.append(e)
            if not self.materialized and isinstance(e, Preemption) \
                    and e.duration_steps > 0:
                expanded.append(NodeJoin(step=e.step + e.duration_steps,
                                         subcluster=e.subcluster,
                                         n_nodes=e.n_nodes,
                                         template=e.template))
        self.events = sorted(expanded, key=lambda e: e.step)
        self.materialized = True

    def at(self, step: int) -> List[ClusterEvent]:
        return [e for e in self.events if e.step == step]

    def cluster_at(self, base: HeteroCluster, step: int) -> HeteroCluster:
        """Fleet state just before step ``step`` begins (events at ``step``
        itself already applied — they strike at the step boundary)."""
        cl = base
        for e in self.events:
            if e.step > step:
                break
            cl = apply_event(cl, e)
        return cl

    @property
    def last_step(self) -> int:
        return self.events[-1].step if self.events else 0

    def describe(self) -> str:
        return " -> ".join(e.describe() for e in self.events) or "(empty)"


def paper_trace(cluster: HeteroCluster, *,
                fail_step: int = 60, bw_step: int = 100,
                recover_step: int = 150,
                degraded_gbps: float = 2.0) -> EventTrace:
    """The benchmark's scripted disruption: one node of the *weakest*
    sub-cluster with spare nodes fails, then the cross link congests, then
    both recover.  (Single-node sub-clusters are skipped so the rejoin can
    resolve the name; a whole-sub-cluster outage needs ``NodeJoin.template``.)
    """
    candidates = [s for s in cluster.subclusters if s.n_nodes >= 2] \
        or list(cluster.subclusters)
    weakest = min(candidates, key=lambda s: s.device.effective_flops)
    return EventTrace([
        NodeFailure(step=fail_step, subcluster=weakest.name, n_nodes=1),
        BandwidthShift(step=bw_step, cross_bw=degraded_gbps * GBPS),
        NodeJoin(step=recover_step, subcluster=weakest.name, n_nodes=1,
                 template=weakest),
        BandwidthShift(step=recover_step, cross_bw=cluster.cross_bw),
    ])


def random_trace(cluster: HeteroCluster, n_steps: int, seed: int = 0, *,
                 p_failure: float = 0.002, p_preempt: float = 0.002,
                 p_bw_shift: float = 0.004, p_straggler: float = 0.004,
                 mean_outage_steps: int = 40) -> EventTrace:
    """Seeded fleet-dynamics generator (per-step Bernoulli hazards).

    Failures schedule their own recovery (mean ``mean_outage_steps``,
    geometric); bandwidth shifts draw uniformly in [0.3, 1.2] x nominal;
    stragglers draw efficiency in [0.4, 0.95].  Deterministic per seed.
    """
    rng = random.Random(seed)
    names = [s.name for s in cluster.subclusters]
    avail: Dict[str, int] = {s.name: s.n_nodes for s in cluster.subclusters}
    events: List[ClusterEvent] = []
    for step in range(1, n_steps):
        r = rng.random()
        if r < p_failure + p_preempt:   # preempt = upper part of the band
            name = rng.choice(names)
            if avail[name] <= 1:
                continue    # never drop a sub-cluster's last node
            outage = max(1, int(rng.expovariate(1.0 / mean_outage_steps)))
            preempt = r >= p_failure
            if preempt:
                events.append(Preemption(step=step, subcluster=name,
                                         n_nodes=1, duration_steps=outage))
            else:
                events.append(NodeFailure(step=step, subcluster=name))
                events.append(NodeJoin(step=step + outage, subcluster=name))
            avail[name] -= 1
            # NodeJoin return is accounted when its step is reached; keep the
            # conservative floor so concurrent hazards can't over-drain
        elif r < p_failure + p_preempt + p_bw_shift:
            events.append(BandwidthShift(
                step=step,
                cross_bw=cluster.cross_bw * rng.uniform(0.3, 1.2)))
        elif r < p_failure + p_preempt + p_bw_shift + p_straggler:
            events.append(Straggler(step=step, subcluster=rng.choice(names),
                                    efficiency=rng.uniform(0.4, 0.95)))
    return EventTrace(events)
