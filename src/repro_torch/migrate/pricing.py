"""Exact migration pricing: the differ's transfer set through the comm
subsystem's topology + fair-share netsim, overlapped with the old plan's
drain.

Migration traffic rides the *same* tiered links as training
(``repro_torch.comm.topology``): a transfer between two devices on one node is
``intra:{name}``, across nodes of one sub-cluster ``ib:{name}``, across
sub-clusters the shared ``wan`` (with its per-transfer latency).
Checkpoint-restored bytes (no surviving replica) ride a dedicated restore
path at ``restore_bw``.

The **overlap scheduler** prices the migration *against the tail of the
old plan's final step* instead of stop-the-world:

- each old stage's parameters are final only after its last microbatch
  backward + its per-step gradient sync — late pipeline stages finish their
  backwards early (1F1B), so their shards prefetch while early stages are
  still draining;
- the drain's own traffic (remaining boundary activation sends, gradient
  syncs on their physical links) contends fairly with migration flows that
  share a link — a WAN-crossing migration slows under the WAN sync it
  overlaps, exactly as ``repro_torch.comm.netsim`` resolves it;
- transfers between one (src, dst) device pair ride one connection (one
  fair-share flow), released when the source stage's state is final.

``charged downtime = max(0, overlapped makespan - drain-alone makespan)``
— the wall clock the ElasticController bills to the amortization rule; the
old plan was going to spend the drain regardless.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.comm.netsim import SimNode, run
from repro_torch.comm.selector import collective_breakdown
from repro_torch.comm.topology import CROSS_LINK, Topology, build_topology
from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.layering import Layer
from repro_torch.core.pipesim import simulate
from repro_torch.core.strategy import ParallelStrategy
from repro_torch.migrate.differ import MigrationPlan, Transfer
from repro_torch.migrate.layout import DeviceId, PlanLayout

RESTORE_LINK = "__restore__"           # shared checkpoint-restore path
DEFAULT_RESTORE_BW = 2e9               # bytes/s off the checkpoint store


@dataclass
class MigrationCost:
    """Priced migration.  ``downtime_s`` is what the controller charges:
    the overlapped extra wall beyond the old plan's own drain (or the
    serial time when overlap pricing is off)."""
    serial_s: float                    # stop-the-world: migration alone
    overlap_extra_s: float             # extra wall beyond the drain
    drain_s: float                     # old plan's final-step drain alone
    link_bytes: Dict[str, int] = field(default_factory=dict)
    link_seconds: Dict[str, float] = field(default_factory=dict)
    n_flows: int = 0
    overlapped: bool = True
    timeline: Optional[Dict] = None    # per-flow/drain start-end schedule
    # (JSON-safe; populated by price_migration(collect_timeline=True), the
    # input obs.trace_from_migration lowers into Chrome-trace lanes)

    @property
    def downtime_s(self) -> float:
        return self.overlap_extra_s if self.overlapped else self.serial_s

    def describe(self) -> str:
        per_link = ", ".join(f"{l}={b / 1e6:.1f}MB"
                             for l, b in sorted(self.link_bytes.items()))
        return (f"priced migration: {self.downtime_s:.3f}s downtime "
                f"(serial {self.serial_s:.3f}s, drain {self.drain_s:.3f}s, "
                f"{self.n_flows} flows; {per_link or 'no traffic'})")


def classify_link(old: PlanLayout, src: DeviceId, dst: DeviceId,
                  topo: Topology) -> str:
    """The physical link a (src -> dst) migration byte rides."""
    if src[0] == dst[0] and src[0] in topo.subcluster_names:
        dpn = old.devices_per_node.get(src[0], 1)
        if src[1] // dpn == dst[1] // dpn:
            return f"intra:{src[0]}"
        return f"ib:{src[0]}"
    return CROSS_LINK


def _drain_nodes(old_strategy: ParallelStrategy, old_cluster: HeteroCluster,
                 layers: Sequence[Layer]
                 ) -> Tuple[List[SimNode], Dict[int, Tuple]]:
    """The old plan's final-step tail as netsim nodes: per stage a fixed
    drain delay until its last backward, then its gradient sync on its
    physical link.  Returns (nodes, per-stage release node id)."""
    strat = old_strategy
    res = simulate([s.t_f for s in strat.stages],
                   [s.t_b for s in strat.stages],
                   strat.c_links, strat.n_microbatches, strat.warmup_counts)
    last_b = [0.0] * strat.n_stages
    for node, t0 in res.start.items():
        kind, _, i = node
        if kind == "B" and i < strat.n_stages:
            last_b[i] = max(last_b[i], t0 + res.dur[node])
    bd = collective_breakdown(strat, old_cluster, layers)
    nodes: List[SimNode] = []
    release: Dict[int, Tuple] = {}
    for i in range(strat.n_stages):
        drain_id = ("drain", i)
        nodes.append(SimNode(drain_id, last_b[i]))
        e = bd["stages"][i]
        if e["sync_time_s"] > 0 and e["sync_link"]:
            sync_id = ("sync", i)
            nodes.append(SimNode(sync_id, e["sync_time_s"],
                                 deps=(drain_id,), links=(e["sync_link"],)))
            release[i] = sync_id
        else:
            release[i] = drain_id
    # remaining boundary activation traffic on its physical links
    for i, (c, link) in enumerate(zip(strat.c_links, bd["link_ids"])):
        work = c * strat.n_microbatches
        if work > 0:
            nodes.append(SimNode(("act", i), work, links=(link,)))
    return nodes, release


def _flows(mplan: MigrationPlan, old: PlanLayout, topo: Topology, *,
           restore_bw: float) -> Tuple[List[Tuple], Dict[str, int]]:
    """Aggregate transfers into per-(src, dst, stage) connection flows:
    [(flow_id, links, work_seconds, src_stage | None)], plus per-link byte
    totals.  ``src_stage=None`` flows (checkpoint restores) are releasable
    at t=0."""
    agg: Dict[Tuple, Tuple[float, int]] = {}
    link_bytes: Dict[str, int] = {}
    for t in mplan.transfers:
        stage = old.leaf_stage.get(t.leaf)
        if t.src is None:
            key = (None, t.dst, None)
            link, bw, lat = RESTORE_LINK, restore_bw, 0.0
        else:
            link = classify_link(old, t.src, t.dst, topo)
            try:
                l = topo.link(link)
            except KeyError:            # source sub-cluster left the fleet
                l = topo.cross_link()
                link = l.name
            bw, lat = l.bandwidth, l.latency
            key = (t.src, t.dst, stage)
        work, nb = agg.get(key + (link,), (0.0, 0))
        if nb == 0:
            work += lat                 # per-connection startup, once
        agg[key + (link,)] = (work + t.nbytes / bw, nb + t.nbytes)
        link_bytes[link] = link_bytes.get(link, 0) + t.nbytes
    flows = [(("mig",) + key[:3], (key[3],), work, key[2])
             for key, (work, _) in sorted(agg.items(), key=lambda kv: repr(kv))]
    return flows, link_bytes


def _fmt_dev(d: Optional[DeviceId]) -> Optional[str]:
    return None if d is None else f"{d[0]}:{d[1]}"


def _timeline(flows: List[Tuple], res, drain_nodes: Sequence[SimNode],
              release: Dict[int, Tuple], overlapped: bool) -> Dict:
    """JSON-safe flow/drain schedule from a solved netsim run — the exact
    start/end seconds ``obs.trace_from_migration`` renders as lanes."""
    flow_entries = []
    for fid, links, work, stage in flows:
        if fid not in res.start:
            continue
        src, dst = fid[1], fid[2]
        flow_entries.append({
            "id": f"{_fmt_dev(src) or 'ckpt'}->{_fmt_dev(dst)}"
                  + (f"@s{stage}" if stage is not None else ""),
            "src": _fmt_dev(src), "dst": _fmt_dev(dst), "src_stage": stage,
            "link": links[0], "work_s": work,
            "start_s": res.start[fid], "end_s": res.end[fid]})
    release_ids = set(release.values())
    drain_entries = []
    for node in drain_nodes:
        if node.nid not in res.start:
            continue
        kind = node.nid[0]
        drain_entries.append({
            "id": f"{kind}{node.nid[1]}", "kind": kind,
            "stage": node.nid[1],
            "link": node.links[0] if node.links else None,
            "is_release": node.nid in release_ids,
            "start_s": res.start[node.nid], "end_s": res.end[node.nid]})
    return {"overlapped": overlapped, "flows": flow_entries,
            "drain": drain_entries}


def price_migration(mplan: MigrationPlan, old_layout: PlanLayout,
                    new_cluster: HeteroCluster, *,
                    old_strategy: Optional[ParallelStrategy] = None,
                    old_cluster: Optional[HeteroCluster] = None,
                    layers: Optional[Sequence[Layer]] = None,
                    restore_bw: float = DEFAULT_RESTORE_BW,
                    overlap: bool = True,
                    collect_timeline: bool = False) -> MigrationCost:
    """Price ``mplan`` on ``new_cluster``'s surviving links (module
    docstring).  ``old_strategy``/``old_cluster``/``layers`` enable the
    overlap scheduler; without them (or ``overlap=False``) the cost is the
    stop-the-world serial time.  ``collect_timeline=True`` additionally
    keeps the solved per-flow/per-drain-node schedule (prices are
    unchanged — the same runs are solved either way)."""
    topo = build_topology(new_cluster)
    flows, link_bytes = _flows(mplan, old_layout, topo,
                               restore_bw=restore_bw)
    if not flows:
        return MigrationCost(0.0, 0.0, 0.0, {}, {}, 0,
                             overlapped=overlap,
                             timeline={"overlapped": overlap, "flows": [],
                                       "drain": []}
                             if collect_timeline else None)

    # serial: migration alone, contended only among its own flows
    serial = run([SimNode(fid, work, links=links)
                  for fid, links, work, _ in flows])
    link_seconds = dict(serial.link_busy)

    can_overlap = overlap and old_strategy is not None \
        and old_cluster is not None and layers is not None
    if not can_overlap:
        tl = _timeline(flows, serial, (), {}, False) \
            if collect_timeline else None
        return MigrationCost(serial.makespan, serial.makespan, 0.0,
                             link_bytes, link_seconds, len(flows),
                             overlapped=False, timeline=tl)

    drain_nodes, release = _drain_nodes(old_strategy, old_cluster, layers)
    baseline = run(drain_nodes)
    combined = list(drain_nodes)
    for fid, links, work, stage in flows:
        deps = (release[stage],) if stage in release else ()
        combined.append(SimNode(fid, work, deps=deps, links=links))
    full = run(combined)
    extra = max(0.0, full.makespan - baseline.makespan)
    tl = _timeline(flows, full, drain_nodes, release, True) \
        if collect_timeline else None
    return MigrationCost(serial.makespan, extra, baseline.makespan,
                         link_bytes, link_seconds, len(flows),
                         overlapped=True, timeline=tl)
