"""Event-driven link-occupancy simulator with fair-share contention.

The legacy pipeline simulator prices every transfer as an isolated scalar
(``bytes / link_gbps``): two transfers on the same physical link at the same
time each proceed at full rate, which is wrong exactly when it matters —
concurrent activation sends on the shared cross-cluster WAN, or a gradient
sync overlapping the next microbatch's activation traffic.

This module solves the *contended* timing exactly under processor-sharing:

- a **compute node** has a fixed duration and consumes no link;
- a **transfer node** carries ``work`` seconds of service demand *at full
  link rate* and occupies one or more named links (an allreduce occupies
  both directions; a p2p send one).  While ``k`` transfers are active on a
  link, each gets a ``1/k`` share; a multi-link transfer proceeds at its
  most-congested link's share (a deterministic max-min-fairness
  approximation);
- edges are dependencies (``start >= max(dep ends)``) — per-stage issue
  order, per-channel FIFO, and data deps all become edges.

Between events (a compute/transfer completion) the active set is constant,
so rates are piecewise-constant and the simulation is exact: no sampling,
no time stepping.  A transfer that never shares a link finishes in exactly
``work`` seconds — with all-distinct links this degenerates to the legacy
uncontended timing (asserted in tests).

Working in *seconds of service demand* rather than bytes keeps the
simulator composable with the planner's time-valued tables: callers price
``bytes / bw`` once and the netsim only redistributes capacity.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass
from typing import Dict, Hashable, Iterable, List, Sequence, Tuple

_EPS = 1e-12


@dataclass(frozen=True)
class SimNode:
    """One unit of work.  ``links`` empty -> compute (fixed ``work``
    seconds); non-empty -> transfer (``work`` seconds at full rate, shared
    capacity on every named link)."""
    nid: Hashable
    work: float
    deps: Tuple[Hashable, ...] = ()
    links: Tuple[str, ...] = ()

    @property
    def is_transfer(self) -> bool:
        return bool(self.links)


@dataclass
class NetSimResult:
    start: Dict[Hashable, float]
    end: Dict[Hashable, float]
    link_busy: Dict[str, float]    # seconds each link had >= 1 active transfer

    def duration(self, nid: Hashable) -> float:
        return self.end[nid] - self.start[nid]

    @property
    def makespan(self) -> float:
        return max(self.end.values()) if self.end else 0.0


def run(nodes: Sequence[SimNode]) -> NetSimResult:
    """Solve start/end times for a dependency DAG of compute + transfer
    nodes under fair-share link contention (module docstring).  Raises on
    unknown deps or dependency cycles."""
    by_id: Dict[Hashable, SimNode] = {}
    for n in nodes:
        if n.nid in by_id:
            raise ValueError(f"duplicate node id {n.nid!r}")
        if n.work < 0 or not math.isfinite(n.work):
            raise ValueError(f"node {n.nid!r}: bad work {n.work!r}")
        by_id[n.nid] = n
    indeg: Dict[Hashable, int] = {n.nid: 0 for n in nodes}
    succ: Dict[Hashable, List[Hashable]] = {n.nid: [] for n in nodes}
    for n in nodes:
        for d in n.deps:
            if d not in by_id:
                raise ValueError(f"node {n.nid!r} depends on unknown {d!r}")
            succ[d].append(n.nid)
            indeg[n.nid] += 1

    start: Dict[Hashable, float] = {}
    end: Dict[Hashable, float] = {}
    link_busy: Dict[str, float] = {}
    remaining: Dict[Hashable, float] = {}          # active transfers
    active_on: Dict[str, set] = {}                 # link -> active transfer ids
    compute_done: List[Tuple[float, int, Hashable]] = []   # heap
    seq = 0

    def activate(nid: Hashable, t: float):
        nonlocal seq
        node = by_id[nid]
        start[nid] = t
        if node.is_transfer:
            remaining[nid] = node.work
            for l in node.links:
                active_on.setdefault(l, set()).add(nid)
        else:
            seq += 1
            heapq.heappush(compute_done, (t + node.work, seq, nid))

    def rate(nid: Hashable) -> float:
        return min(1.0 / len(active_on[l]) for l in by_id[nid].links)

    t = 0.0
    for nid, d in indeg.items():
        if d == 0:
            activate(nid, 0.0)

    n_done = 0
    while n_done < len(by_id):
        # next event: earliest compute completion or transfer drain
        t_next = compute_done[0][0] if compute_done else math.inf
        for nid, rem in remaining.items():
            t_next = min(t_next, t + rem / rate(nid))
        if not math.isfinite(t_next):
            raise ValueError("dependency cycle in netsim DAG")
        # advance active transfers at their current (constant) rates
        dt = t_next - t
        if dt > 0:
            for l, act in active_on.items():
                if act:
                    link_busy[l] = link_busy.get(l, 0.0) + dt
            for nid in remaining:
                remaining[nid] -= dt * rate(nid)
        t = t_next

        finished: List[Hashable] = []
        while compute_done and compute_done[0][0] <= t + _EPS:
            finished.append(heapq.heappop(compute_done)[2])
        for nid, rem in list(remaining.items()):
            if rem <= _EPS * max(1.0, by_id[nid].work):
                finished.append(nid)
                del remaining[nid]
                for l in by_id[nid].links:
                    active_on[l].discard(nid)
        if not finished:
            raise ValueError("netsim stalled (no event progressed)")
        ready: List[Hashable] = []
        for nid in finished:
            end[nid] = t
            n_done += 1
            for s in succ[nid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        for nid in ready:
            activate(nid, t)
    return NetSimResult(start, end, link_busy)


def price_transfers(transfers: Iterable[Tuple[Hashable, Sequence[str],
                                              float, float]]
                    ) -> NetSimResult:
    """Standalone front door: price a set of released transfers against each
    other.  Each entry is ``(id, links, work_seconds, release_time)``;
    releases are modeled as zero-link delay nodes so the event loop handles
    them uniformly.  Returns per-transfer (start, end) + link busy time."""
    nodes: List[SimNode] = []
    for tid, links, work, release in transfers:
        deps: Tuple[Hashable, ...] = ()
        if release > 0:
            rel_id = ("__release__", tid)
            nodes.append(SimNode(rel_id, float(release)))
            deps = (rel_id,)
        nodes.append(SimNode(tid, float(work), deps, tuple(links)))
    res = run(nodes)
    res.start = {k: v for k, v in res.start.items()
                 if not (isinstance(k, tuple) and k and k[0] == "__release__")}
    res.end = {k: v for k, v in res.end.items()
               if not (isinstance(k, tuple) and k and k[0] == "__release__")}
    return res
