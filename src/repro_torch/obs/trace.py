"""Typed span/event trace model + deterministic Chrome-trace exporter.

The stack already *computes* every interesting timing artifact — the
pipeline referee's per-(microbatch, stage) start/dur grids, the netsim's
per-transfer intervals, the migration pricer's flow schedule, the serving
simulator's per-pool dispatch heap, the controller's decision log.  This
module only *lowers* them into one common span model (no re-simulation):

- :class:`Span` — one slice on a (process, track) lane, seconds on the
  originating sim clock, with optional flow-arrow endpoints;
- :class:`Trace` — an insertion-ordered container with counter samples and
  free-form metadata, exportable to Chrome-trace / Perfetto JSON
  (``chrome://tracing`` or https://ui.perfetto.dev, "Open trace file");
- ``trace_from_*`` adapters for each timing artifact.

Exactness contract (pinned in ``tests/test_obs.py``): adapters iterate
source artifacts in the *same element order* as the producing engine's own
reductions, so summing span durations reproduces the engine's totals bit
for bit — ``trace_from_sim`` emits each stage's compute spans in
``_stage_order`` issue order (the order ``stage_compute`` accumulates in)
and each boundary's comm spans CF/CB-alternating per microbatch (the order
``comm_total`` accumulates in).  ``comm_exposed`` is *not* reconstructible
from spans (it is a clamped sum of dependency-delay contributions), so the
verbatim float rides in ``Trace.meta`` instead.

Determinism: pids/tids are assigned in first-use order, events are emitted
in insertion order, and no wall-clock timestamp ever enters the file —
identical inputs produce byte-identical JSON.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

OBS_TRACE_SCHEMA = 1


@dataclass
class Span:
    """One complete slice.  ``ts``/``dur`` are *seconds* on the source sim
    clock (the exporter converts to Chrome's microseconds).  ``flow_start``
    emits a flow-arrow origin at the span's end, ``flow_end`` a termination
    at its start (both keyed by ``flow_id``)."""
    process: str
    track: str
    name: str
    cat: str
    ts: float
    dur: float
    args: Dict[str, Any] = field(default_factory=dict)
    flow_id: Optional[int] = None
    flow_start: bool = False
    flow_end: bool = False

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Counter:
    """One counter sample (Chrome ``ph:"C"``): a named multi-series value
    at one instant."""
    process: str
    name: str
    ts: float
    values: Dict[str, float] = field(default_factory=dict)


class Trace:
    """Insertion-ordered span/counter container with free-form metadata."""

    def __init__(self, name: str = "trace",
                 meta: Optional[Dict[str, Any]] = None):
        self.name = name
        self.meta: Dict[str, Any] = dict(meta or {})
        self.spans: List[Span] = []
        self.counters: List[Counter] = []

    def add_span(self, process: str, track: str, name: str, cat: str,
                 ts: float, dur: float,
                 args: Optional[Dict[str, Any]] = None,
                 flow_id: Optional[int] = None,
                 flow_start: bool = False, flow_end: bool = False) -> Span:
        s = Span(process, track, name, cat, float(ts), float(dur),
                 dict(args or {}), flow_id, flow_start, flow_end)
        self.spans.append(s)
        return s

    def add_counter(self, process: str, name: str, ts: float,
                    values: Dict[str, float]) -> Counter:
        c = Counter(process, name, float(ts), dict(values))
        self.counters.append(c)
        return c

    def extend(self, other: "Trace") -> "Trace":
        """Merge ``other``'s spans/counters/meta into this trace (insertion
        order preserved; meta keys from ``other`` win on collision)."""
        self.spans.extend(other.spans)
        self.counters.extend(other.counters)
        self.meta.update(other.meta)
        return self

    # -- export --------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome-trace JSON object format: ``X`` slices, ``C`` counters,
        ``s``/``f`` flow arrows, ``M`` process/thread names.  Deterministic:
        first-use pid/tid assignment, insertion-order events, sorted keys
        at dump time, timestamps in microseconds of *sim* time."""
        pids: Dict[str, int] = {}
        tids: Dict[tuple, int] = {}
        events: List[Dict[str, Any]] = []

        def pid(process: str) -> int:
            if process not in pids:
                pids[process] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pids[process], "tid": 0,
                               "args": {"name": process}})
            return pids[process]

        def tid(process: str, track: str) -> int:
            key = (process, track)
            if key not in tids:
                p = pid(process)
                tids[key] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": p, "tid": tids[key],
                               "args": {"name": track}})
            return tids[key]

        for s in self.spans:
            p, t = pid(s.process), tid(s.process, s.track)
            events.append({"ph": "X", "name": s.name, "cat": s.cat,
                           "pid": p, "tid": t,
                           "ts": s.ts * 1e6, "dur": s.dur * 1e6,
                           "args": s.args})
            if s.flow_id is not None and s.flow_end:
                events.append({"ph": "f", "bp": "e", "id": s.flow_id,
                               "name": "flow", "cat": s.cat,
                               "pid": p, "tid": t, "ts": s.ts * 1e6})
            if s.flow_id is not None and s.flow_start:
                events.append({"ph": "s", "id": s.flow_id,
                               "name": "flow", "cat": s.cat,
                               "pid": p, "tid": t, "ts": s.end * 1e6})
        for c in self.counters:
            events.append({"ph": "C", "name": c.name, "cat": "counter",
                           "pid": pid(c.process), "tid": 0,
                           "ts": c.ts * 1e6, "args": c.values})
        return {"traceEvents": events,
                "otherData": {"schema": OBS_TRACE_SCHEMA,
                              "name": self.name, "meta": self.meta}}

    def makespan(self) -> float:
        if "makespan_s" in self.meta:
            return float(self.meta["makespan_s"])
        return max((s.end for s in self.spans), default=0.0)


def trace_to_chrome(trace: Trace, path: str) -> str:
    """Write ``trace`` as Chrome-trace JSON at ``path`` (byte-deterministic
    for identical traces)."""
    with open(path, "w") as f:
        json.dump(trace.to_chrome(), f, sort_keys=True, indent=1)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# Adapter: pipeline referee (core.pipesim.SimResult)
# ---------------------------------------------------------------------------


def trace_from_sim(res, name: str = "pipeline-step") -> Trace:
    """Lower a :class:`repro_torch.core.pipesim.SimResult` into per-stage compute
    tracks + per-boundary comm tracks, phase-tagged (warmup / steady /
    cooldown) — iterating in the engines' own accumulation order so span
    sums reproduce ``stage_compute`` / ``comm_total`` bit for bit (module
    docstring).  ``comm_exposed`` rides in ``meta`` verbatim."""
    from repro_torch.core.pipesim import _stage_order

    S = len(res.stage_compute)
    B = 1 + max((j for (k, j, _i) in res.start if k == "F"), default=-1)
    tr = Trace(name, meta={
        "makespan_s": res.makespan,
        "comm_total_s": res.comm_total,
        "comm_exposed_s": res.comm_exposed,
        "stage_compute_s": list(res.stage_compute),
        "stage_intra_comm_s": list(res.stage_intra_comm),
        "warmup_counts": list(res.warmup_counts),
        "n_microbatches": B,
    })
    for i in range(S):
        n_w = min(res.warmup_counts[i], B)
        for kind, j in _stage_order(i, S, B, res.warmup_counts[i]):
            node = (kind, j, i)
            if node not in res.start:
                continue
            if kind == "F":
                phase = "warmup" if j < n_w else "steady"
            else:
                phase = "cooldown" if j >= B - n_w else "steady"
            tr.add_span("pipeline", f"stage{i}", f"{kind}{j}", "compute",
                        res.start[node], res.dur[node],
                        args={"kind": kind, "mb": j, "stage": i,
                              "phase": phase})
    # comm spans CF/CB-alternating per microbatch: the exact element order
    # both engines accumulate comm_total in (no_overlap elides zero-cost
    # comm nodes — hence the membership guards)
    for i in range(S - 1):
        for j in range(B):
            for kind in ("CF", "CB"):
                node = (kind, j, i)
                if node not in res.start:
                    continue
                tr.add_span("pipeline", f"comm{i}->{i + 1}", f"{kind}{j}",
                            "comm", res.start[node], res.dur[node],
                            args={"kind": kind, "mb": j, "boundary": i})
    for node in res.start:
        if node[0] == "SYNC":
            tr.add_span("pipeline", f"sync{node[2]}", "SYNC", "comm",
                        res.start[node], res.dur[node],
                        args={"kind": "SYNC", "stage": node[2]})
    if res.link_busy:
        tr.add_counter("pipeline", "link_busy_s", 0.0,
                       {k: res.link_busy[k] for k in sorted(res.link_busy)})
    return tr


def render_ascii(trace: Trace, width: int = 100) -> str:
    """Paper Fig. 3-style timeline from a ``trace_from_sim`` trace — the
    single span source behind ``Executable.describe(timeline=True)``.

    Pixel math and paint order replicate ``pipesim.ascii_timeline`` on
    fast-path results exactly (per stage: all forwards ascending mb, then
    all backwards — the engine's dict insertion order), pinned equal in
    tests."""
    compute = [s for s in trace.spans if s.cat == "compute"]
    if not compute:
        return ""
    stages = sorted({s.args["stage"] for s in compute})
    makespan = trace.makespan()
    scale = width / makespan
    rows = []
    for i in stages:
        row = [" "] * (width + 1)
        mine = [s for s in compute if s.args["stage"] == i]
        mine.sort(key=lambda s: (s.args["kind"] != "F", s.args["mb"]))
        for sp in mine:
            s0 = int(sp.ts * scale)
            e0 = max(s0 + 1, int(sp.end * scale))
            ch = "f" if sp.args["kind"] == "F" else "B"
            for x in range(s0, min(e0, width)):
                row[x] = ch
        rows.append(f"stage{i}|" + "".join(row))
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# Adapter: fair-share network simulator (comm.netsim)
# ---------------------------------------------------------------------------


def trace_from_netsim(nodes: Sequence, res,
                      name: str = "netsim") -> Trace:
    """Lower a netsim run into per-link lanes.  ``NetSimResult`` records
    timing but not link membership, so the original ``SimNode`` list rides
    along; a multi-link transfer lands on its first link's lane with the
    full link set in ``args``.  Internal ``("__release__", ...)`` delay
    nodes are skipped."""
    tr = Trace(name, meta={"makespan_s": res.makespan,
                           "link_busy_s": {k: res.link_busy[k]
                                           for k in sorted(res.link_busy)}})
    for n in nodes:
        nid = n.nid
        if isinstance(nid, tuple) and nid and nid[0] == "__release__":
            continue
        if nid not in res.start:
            continue
        track = n.links[0] if n.links else "compute"
        tr.add_span("netsim", track, str(nid),
                    "comm" if n.links else "compute",
                    res.start[nid], res.end[nid] - res.start[nid],
                    args={"links": list(n.links), "work_s": n.work})
    return tr


# ---------------------------------------------------------------------------
# Adapter: migration pricing (migrate.pricing.MigrationCost.timeline)
# ---------------------------------------------------------------------------


def trace_from_migration(cost, name: str = "migration") -> Trace:
    """Lower a priced migration's flow schedule into drain lanes + per-link
    ``mig:`` lanes, flow arrows from each source stage's release span (its
    drain tail / gradient sync) to the migration flows it gates.

    Requires ``price_migration(..., collect_timeline=True)`` — raises
    ``ValueError`` on a cost priced without a timeline."""
    if getattr(cost, "timeline", None) is None:
        raise ValueError(
            "MigrationCost has no timeline; price with "
            "price_migration(..., collect_timeline=True)")
    tl = cost.timeline
    tr = Trace(name, meta={
        "downtime_s": cost.downtime_s, "serial_s": cost.serial_s,
        "drain_s": cost.drain_s, "overlapped": cost.overlapped,
        "n_flows": cost.n_flows,
        "link_bytes": {k: cost.link_bytes[k]
                       for k in sorted(cost.link_bytes)},
    })
    # one flow-arrow id per gating stage, shared by its release span and
    # every flow it releases
    flow_ids = {f["src_stage"] for f in tl["flows"]
                if f["src_stage"] is not None}
    fid_of = {stage: k for k, stage in enumerate(sorted(flow_ids))}
    for d in tl["drain"]:
        stage = d.get("stage")
        track = f"stage{stage}" if stage is not None else str(d["id"])
        fid = fid_of.get(stage) if d.get("is_release") else None
        tr.add_span("migration", track, d["kind"], "drain",
                    d["start_s"], d["end_s"] - d["start_s"],
                    args={"kind": d["kind"], "stage": stage,
                          "link": d.get("link")},
                    flow_id=fid, flow_start=fid is not None)
    for f in tl["flows"]:
        fid = fid_of.get(f["src_stage"])
        tr.add_span("migration", f"mig:{f['link']}", f["id"], "migration",
                    f["start_s"], f["end_s"] - f["start_s"],
                    args={"src": f["src"], "dst": f["dst"],
                          "src_stage": f["src_stage"], "link": f["link"],
                          "work_s": f["work_s"]},
                    flow_id=fid, flow_end=fid is not None)
    return tr


# ---------------------------------------------------------------------------
# Adapter: serving simulator dispatch log (serving.batching recorder)
# ---------------------------------------------------------------------------


def trace_from_serve(events: Sequence, name: str = "serving") -> Trace:
    """Lower a ``simulate_trace(..., recorder=...)`` dispatch log — entries
    ``(t, dur, pool_idx, pool_name, kind, n)`` — into per-pool
    prefill/decode lanes (``n`` = chunk tokens for prefill, batch size for
    decode)."""
    tr = Trace(name)
    busy: Dict[str, float] = {}
    for (t, dur, idx, pool_name, kind, n) in events:
        tr.add_span("serving", pool_name, kind, "serve", t, dur,
                    args={"pool": idx, "kind": kind, "n": n})
        busy[f"{pool_name}/{kind}"] = busy.get(f"{pool_name}/{kind}", 0.0) \
            + dur
    tr.meta["pool_busy_s"] = {k: busy[k] for k in sorted(busy)}
    return tr


# ---------------------------------------------------------------------------
# Adapter: controller decision log (runtime.controller.ReplanDecision)
# ---------------------------------------------------------------------------


def trace_from_decisions(decisions: Sequence,
                         wall_times: Optional[Dict[int, float]] = None,
                         name: str = "controller") -> Trace:
    """Lower a decision log into one controller track: a span per
    :class:`ReplanDecision` (every decision present — pinned in tests), dur
    = its charged downtime.  ``wall_times`` (step -> replay-clock seconds)
    places spans on the sim clock; without it ``ts`` is the step index."""
    tr = Trace(name, meta={"n_decisions": len(decisions),
                           "clock": "wall" if wall_times else "step"})
    for d in decisions:
        ts = wall_times.get(d.step, float(d.step)) if wall_times \
            else float(d.step)
        tr.add_span("controller", "decisions", d.action, "decision",
                    ts, d.downtime_s,
                    args={"step": d.step, "action": d.action,
                          "reason": d.reason,
                          "event": None if d.event is None else str(d.event),
                          "search_time_s": d.search_time_s,
                          "migration_s": d.migration_s,
                          "migration_bytes": d.migration_bytes,
                          "coalesced": d.coalesced,
                          "serve_replanned": d.serve_replanned,
                          "plan_cache_hit": d.plan_cache_hit})
    return tr
