"""Fleet fault models and storm generators.

Every fault here *lowers onto the existing typed events* in
:mod:`repro_torch.runtime.events` — a correlated rack failure is one
``NodeFailure`` with the rack's blast radius, a flapping node is an
alternating fail/rejoin sequence, a WAN brownout is a ramp of
``BandwidthShift`` s with a scheduled recovery — so ``apply_event`` and
every consumer of :class:`EventTrace` work unchanged.  The generators are
seeded and deterministic, and traces round-trip through JSON
(:func:`trace_to_json` / :func:`trace_from_json`) so a storm that broke
the controller once ships as a regression fixture forever.

Units: steps are training steps, bandwidths bytes/s, efficiencies are
absolute multipliers on device spec.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, List, Optional

from repro_torch.core.cluster import (
    HeteroCluster, SubCluster, subcluster_from_dict, subcluster_index,
)
from repro_torch.runtime.events import (
    BandwidthShift, ClusterEvent, EventTrace, NodeFailure, NodeJoin,
    Preemption, Straggler,
)

TRACE_SCHEMA = 1

_EVENT_TYPES = {cls.__name__: cls for cls in
                (NodeFailure, NodeJoin, BandwidthShift, Straggler,
                 Preemption)}


# ---------------------------------------------------------------------------
# Event / trace (de)serialization
# ---------------------------------------------------------------------------


def event_to_dict(e: ClusterEvent) -> Dict:
    """One typed event as JSON-native data, tagged with its type name
    (``SubCluster`` templates serialize as full specs)."""
    name = type(e).__name__
    if name not in _EVENT_TYPES:
        raise TypeError(f"unknown cluster event {e!r}")
    d = json.loads(json.dumps(dataclasses.asdict(e)))
    d["type"] = name
    return d


def event_from_dict(d: Dict) -> ClusterEvent:
    d = dict(d)
    cls = _EVENT_TYPES[d.pop("type")]
    if d.get("template") is not None:
        d["template"] = subcluster_from_dict(d["template"])
    return cls(**d)


def trace_to_json(trace: EventTrace, indent: Optional[int] = None) -> str:
    """Lossless trace serialization.  The emitted event list is the
    *materialized* one (Preemption returns already expanded), flagged so
    deserialization doesn't expand them a second time."""
    return json.dumps({
        "schema": TRACE_SCHEMA,
        "materialized": True,
        "events": [event_to_dict(e) for e in trace.events],
    }, indent=indent)


def trace_from_json(s: str) -> EventTrace:
    d = json.loads(s)
    if d.get("schema") != TRACE_SCHEMA:
        raise ValueError(
            f"unsupported trace schema {d.get('schema')!r} "
            f"(expected {TRACE_SCHEMA})")
    return EventTrace([event_from_dict(ed) for ed in d["events"]],
                      materialized=bool(d.get("materialized", True)))


# ---------------------------------------------------------------------------
# Fault models — each returns a list of typed events (compose freely)
# ---------------------------------------------------------------------------


def _resolve_sub(cluster: HeteroCluster,
                 subcluster: Optional[str]) -> SubCluster:
    if subcluster is None:
        # default blast target: the largest pool (worst case for the plan)
        return max(cluster.subclusters, key=lambda s: s.n_nodes)
    return cluster.subclusters[subcluster_index(cluster, subcluster)]


def correlated_failure(cluster: HeteroCluster, *, step: int,
                       subcluster: Optional[str] = None,
                       n_nodes: Optional[int] = None,
                       outage_steps: int = 0) -> List[ClusterEvent]:
    """Rack-scale blast radius: ``n_nodes`` of one pool (the whole pool by
    default) fail *at the same step*.  ``outage_steps > 0`` schedules a
    templated rejoin, so the pool comes back even if it drained entirely."""
    sub = _resolve_sub(cluster, subcluster)
    n = sub.n_nodes if n_nodes is None else n_nodes
    events: List[ClusterEvent] = [
        NodeFailure(step=step, subcluster=sub.name, n_nodes=n)]
    if outage_steps > 0:
        events.append(NodeJoin(step=step + outage_steps, subcluster=sub.name,
                               n_nodes=n, template=sub))
    return events


def flapping_node(cluster: HeteroCluster, *, start: int,
                  subcluster: Optional[str] = None, n_flaps: int = 4,
                  down_steps: int = 2, up_steps: int = 4
                  ) -> List[ClusterEvent]:
    """A node that cycles fail -> rejoin ``n_flaps`` times (period
    ``down_steps + up_steps``).  The debounce/hysteresis hardening exists
    so this costs one replan, not ``n_flaps``."""
    sub = _resolve_sub(cluster, subcluster)
    events: List[ClusterEvent] = []
    t = start
    for _ in range(n_flaps):
        events.append(NodeFailure(step=t, subcluster=sub.name, n_nodes=1))
        events.append(NodeJoin(step=t + down_steps, subcluster=sub.name,
                               n_nodes=1, template=sub))
        t += down_steps + up_steps
    return events


def slow_then_dead(cluster: HeteroCluster, *, start: int,
                   subcluster: Optional[str] = None,
                   efficiency: float = 0.5, degrade_steps: int = 20
                   ) -> List[ClusterEvent]:
    """The classic straggler arc: a pool degrades to ``efficiency`` x spec,
    limps for ``degrade_steps``, then the sick node dies — at which point
    the surviving nodes run at spec again (the straggler is gone)."""
    sub = _resolve_sub(cluster, subcluster)
    nominal = sub.device.efficiency
    return [
        Straggler(step=start, subcluster=sub.name, efficiency=efficiency),
        NodeFailure(step=start + degrade_steps, subcluster=sub.name,
                    n_nodes=1),
        Straggler(step=start + degrade_steps, subcluster=sub.name,
                  efficiency=nominal),
    ]


def wan_brownout(cluster: HeteroCluster, *, start: int, depth: float = 0.3,
                 duration: int = 40, ramp: int = 0) -> List[ClusterEvent]:
    """Transient cross-cluster congestion: the WAN link dips to ``depth`` x
    nominal and recovers to nominal at ``start + duration``.  ``ramp`` > 0
    descends in that many intermediate shifts (geometric) instead of one
    cliff — the gradual-brownout case planners tend to thrash on."""
    if not 0 < depth <= 1:
        raise ValueError("brownout depth must be in (0, 1]")
    if duration <= ramp:
        raise ValueError("brownout must outlast its down-ramp "
                         f"(duration={duration} <= ramp={ramp})")
    nominal = cluster.cross_bw
    events: List[ClusterEvent] = []
    for i in range(ramp + 1):
        frac = depth ** ((i + 1) / (ramp + 1))
        events.append(BandwidthShift(step=start + i, cross_bw=nominal * frac))
    events.append(BandwidthShift(step=start + duration, cross_bw=nominal))
    return events


# ---------------------------------------------------------------------------
# Storm generator — seeded composition of the models above
# ---------------------------------------------------------------------------


def chaos_storm(cluster: HeteroCluster, n_steps: int, seed: int = 0, *,
                intensity: float = 1.0,
                p_flap: float = 0.004, p_rack: float = 0.002,
                p_brownout: float = 0.004, p_straggle: float = 0.004,
                p_preempt: float = 0.003,
                mean_outage_steps: int = 40) -> EventTrace:
    """Seeded event storm: per-step Bernoulli hazards draw from the fault
    catalog (flapping, correlated rack failure, WAN brownout, straggler /
    slow-then-dead, templated preemption), all scaled by ``intensity``.

    Invariants the generator maintains so the *trace itself* is well-formed
    (every event appliable in order — chaos tests the controller, not
    ``apply_event``): the fleet never drains to zero nodes, and a pool with
    a fault sequence in flight is locked against overlapping removals.
    Registered as event source ``"chaos"``.
    """
    rng = random.Random(f"chaos-storm:{seed}")
    hazards = {k: min(1.0, v * intensity) for k, v in
               dict(flap=p_flap, rack=p_rack, brownout=p_brownout,
                    straggle=p_straggle, preempt=p_preempt).items()}
    avail: Dict[str, int] = {s.name: s.n_nodes for s in cluster.subclusters}
    specs: Dict[str, SubCluster] = {s.name: s for s in cluster.subclusters}
    busy_until: Dict[str, int] = {name: 0 for name in avail}
    pending: Dict[int, List] = {}   # step -> [(pool, delta_nodes), ...]
    events: List[ClusterEvent] = []

    def outage() -> int:
        return max(1, int(rng.expovariate(1.0 / mean_outage_steps)))

    def schedule(pool: str, at: int, delta: int) -> None:
        pending.setdefault(at, []).append((pool, delta))

    def fleet_nodes() -> int:
        return sum(avail.values())

    def pick_pool(step: int, min_nodes: int) -> Optional[str]:
        ok = [n for n in avail
              if avail[n] >= min_nodes and busy_until[n] <= step]
        return rng.choice(sorted(ok)) if ok else None

    for step in range(1, n_steps):
        for pool, delta in pending.pop(step, ()):   # returns land first
            avail[pool] += delta
        r = rng.random()
        edge = 0.0
        if r < (edge := edge + hazards["flap"]):
            name = pick_pool(step, min_nodes=1)
            if name is None or fleet_nodes() <= 1:
                continue
            n_flaps = rng.randint(2, 4)
            down, up = rng.randint(1, 3), rng.randint(2, 5)
            seq = flapping_node(cluster, start=step, subcluster=name,
                                n_flaps=n_flaps, down_steps=down,
                                up_steps=up)
            events.extend(seq)
            end = step + n_flaps * (down + up) + 1
            busy_until[name] = end
            # the flapped node is really down during each cycle's down
            # phase — count it out for the whole window so a concurrent
            # whole-rack loss elsewhere can't drain the fleet at the dip
            avail[name] -= 1
            schedule(name, end, 1)
        elif r < (edge := edge + hazards["rack"]):
            name = pick_pool(step, min_nodes=1)
            if name is None or fleet_nodes() - avail[name] < 1:
                continue    # whole-rack loss must leave the fleet alive
            back = outage()
            events.extend(correlated_failure(
                cluster, step=step, subcluster=name, n_nodes=avail[name],
                outage_steps=back))
            schedule(name, step + back, avail[name])
            busy_until[name] = step + back + 1
            avail[name] = 0
        elif r < (edge := edge + hazards["brownout"]):
            rampn = rng.randint(0, 2)
            events.extend(wan_brownout(
                cluster, start=step, depth=rng.uniform(0.2, 0.6),
                duration=max(outage(), rampn + 1), ramp=rampn))
        elif r < (edge := edge + hazards["straggle"]):
            name = pick_pool(step, min_nodes=2)
            if name is None:
                continue
            if rng.random() < 0.5:
                events.append(Straggler(step=step, subcluster=name,
                                        efficiency=rng.uniform(0.4, 0.95)))
            else:
                degrade = rng.randint(5, 25)
                events.extend(slow_then_dead(
                    cluster, start=step, subcluster=name,
                    efficiency=rng.uniform(0.4, 0.8),
                    degrade_steps=degrade))
                busy_until[name] = step + degrade + 1
                schedule(name, step + degrade, -1)
        elif r < edge + hazards["preempt"]:
            name = pick_pool(step, min_nodes=1)
            if name is None or (avail[name] <= 1 and fleet_nodes() <= 1):
                continue
            n = 1 if avail[name] > 1 else avail[name]
            if n == avail[name] and fleet_nodes() - n < 1:
                continue
            back = outage()
            events.append(Preemption(step=step, subcluster=name, n_nodes=n,
                                     duration_steps=back,
                                     template=specs[name]))
            schedule(name, step + back, n)
            busy_until[name] = step + back + 1
            avail[name] -= n
    return EventTrace(events)
