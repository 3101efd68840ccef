"""Per-collective algorithm auto-selection + the planner-facing comm model.

:class:`CommModel` binds a fleet's :class:`~repro_torch.comm.topology.Topology` to
a :class:`CommConfig` and answers the three questions the planner asks:

- ``tp_allreduce`` / ``dp_sync`` / ``cross_sync`` — select the cheapest
  registered algorithm for a collective (HAP-style: the *search* sees the
  selected algorithm's cost, so plans are chosen under the algorithm that
  will actually run, not an implicit flat ring);
- ``p2p_seconds`` — point-to-point activation pricing with the WAN link's
  per-transfer latency (the legacy scalar drops it);
- ``fingerprint`` — stable identity for every cache keyed on comm pricing
  (profiler cost cache, controller plan cache).

With ``compressed=True``, collectives whose group crosses the WAN also get
int8 block-quantized candidates: the wire payload shrinks to the exact
:mod:`repro.parallel.compression` accounting (int8 + one f32 scale per
256-element block, padded — asserted bit-exact against the real quantizer
in tests) while quantize/dequantize cost is charged at
``quant_bytes_per_s`` on each side.  Error feedback makes the quantization
bias-free, so the selector may choose compression on cost alone.

This module never imports the api package or jax at import time, so the
numpy-only planner stack stays light.

Units: bytes, bytes/s, seconds.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from repro_torch.comm import topology as topo_lib
from repro_torch.comm.algorithms import get_algorithm
from repro_torch.comm.topology import CommGroup, build_topology

if TYPE_CHECKING:       # typing only: repro_torch.comm must not import repro_torch.core
    from repro_torch.core.cluster import HeteroCluster    # (cycle via planner)

# mirrors repro.parallel.compression.BLOCK (that module imports jax, which
# the planner stack must not pay for; tests pin the two constants equal)
QUANT_BLOCK = 256
_SCALE_BYTES = 4      # one f32 scale per block


@dataclass
class CommConfig:
    """Planner-facing comm knobs (JSON-native: rides on ``PlannerConfig``).

    ``enabled=False`` (or a ``None`` config on the planner) keeps the legacy
    scalar pricing bit-identical.  ``algorithms`` is the candidate set, in
    tie-breaking order, resolved by name from the collective registry.
    ``contention`` asks executors/benchmarks to simulate with the netsim
    fair-share engine (the planner's closed forms are contention-free either
    way).  ``elem_bytes`` is the bytes-per-element of gradients on the wire
    before compression (f32 = 4)."""
    enabled: bool = True
    algorithms: Tuple[str, ...] = ("ring", "rhd", "hierarchical")
    compressed: bool = False
    contention: bool = False
    p2p_latency: bool = True
    quant_bytes_per_s: float = 100e9
    elem_bytes: float = 4.0

    def __post_init__(self):
        self.algorithms = tuple(self.algorithms)
        if not self.algorithms:
            raise ValueError("CommConfig.algorithms must not be empty")


@dataclass(frozen=True)
class Selection:
    """One selected collective: the winning algorithm and its pricing."""
    algorithm: str
    seconds: float                 # wall time of one collective
    payload_bytes: float           # logical payload (pre-compression)
    wire_bytes: float              # what actually crosses the links
    compressed: bool = False
    link_busy: Dict[str, float] = field(default_factory=dict)


def compressed_wire_bytes(nbytes: float, elem_bytes: float = 4.0) -> float:
    """Exact int8 block-quantization wire accounting for a payload of
    ``nbytes`` (``nbytes / elem_bytes`` elements): int8 per element, padded
    to whole :data:`QUANT_BLOCK` blocks, plus one f32 scale per block —
    matches ``repro.parallel.compression.quantize_int8`` byte for byte."""
    elems = nbytes / elem_bytes
    nblocks = math.ceil(elems / QUANT_BLOCK)
    return float(nblocks * (QUANT_BLOCK + _SCALE_BYTES))


class CommModel:
    """Topology + config -> priced, algorithm-selected collectives."""

    def __init__(self, cluster: HeteroCluster,
                 cfg: Optional[CommConfig] = None):
        self.cluster = cluster
        self.cfg = cfg if cfg is not None else CommConfig()
        self.topology = build_topology(cluster)
        # resolve once: unknown names fail at model build, not mid-search
        self._algos = [(name, get_algorithm(name))
                       for name in self.cfg.algorithms]

    # -- identity ------------------------------------------------------------

    def fingerprint(self) -> str:
        c = self.cfg
        return (f"{topo_lib.fingerprint(self.topology)}"
                f"|algos:{','.join(c.algorithms)}"
                f"|comp:{int(c.compressed)}:{c.quant_bytes_per_s:.6g}"
                f":{c.elem_bytes:.6g}|lat:{int(c.p2p_latency)}")

    def sub_fingerprint(self, sub_idx: int) -> str:
        """Identity of what *stage-local* collective pricing reads for one
        sub-cluster: its own links, node scales, and the selection config —
        deliberately NOT the rest of the fleet, so the profiler's cost
        cache keeps serving untouched sub-clusters across fleet changes
        (the elastic runtime's incremental-replan invariant).  TP
        all-reduces and DP syncs never leave the sub-cluster; cut pricing
        (which does read the WAN) lives in the DP, not in this cache."""
        t = self.topology
        intra, inter = t.intra_link(sub_idx), t.inter_link(sub_idx)
        scales = ",".join(f"{x:.6g}" for x in t.node_scales[sub_idx])
        c = self.cfg
        return (f"{intra.tier}:{intra.bandwidth:.6g}:{inter.bandwidth:.6g}"
                f":[{scales}]|algos:{','.join(c.algorithms)}"
                f"|comp:{int(c.compressed)}:{c.quant_bytes_per_s:.6g}"
                f":{c.elem_bytes:.6g}")

    # -- selection -----------------------------------------------------------

    def select(self, group: CommGroup, nbytes: float) -> Selection:
        """Cheapest candidate for one allreduce of ``nbytes`` over
        ``group``.  Candidates are the supported registered algorithms, in
        config order (first strict minimum wins ties — so on uniform links,
        where every bandwidth-optimal algorithm degenerates to the same
        closed form, the flat ring is selected), plus int8-compressed
        variants of each when enabled and the group crosses the WAN."""
        best: Optional[Selection] = None
        for name, algo in self._algos:
            if not algo.supports(group):
                continue
            cost = algo.cost(group, nbytes)
            cand = Selection(name, cost.seconds, nbytes, nbytes,
                             link_busy=cost.link_busy)
            if best is None or cand.seconds < best.seconds:
                best = cand
            if self.cfg.compressed and group.crosses_wan:
                wire = compressed_wire_bytes(nbytes, self.cfg.elem_bytes)
                ccost = algo.cost(group, wire)
                overhead = 2.0 * nbytes / self.cfg.quant_bytes_per_s
                cand = Selection(name, ccost.seconds + overhead, nbytes,
                                 wire, compressed=True,
                                 link_busy=ccost.link_busy)
                if cand.seconds < best.seconds:
                    best = cand
        if best is None:
            raise RuntimeError(
                f"no registered algorithm supports group {group} "
                f"(candidates: {[n for n, _ in self._algos]})")
        return best

    # -- the planner's three collectives ------------------------------------

    def tp_allreduce(self, sub_idx: int, tp: int, nbytes: float) -> Selection:
        """Megatron row-parallel output allreduce, confined to a node."""
        return self.select(self.topology.tp_group(sub_idx, tp), nbytes)

    def dp_sync(self, sub_idx: int, n_nodes: int, per_node: int,
                nbytes: float) -> Selection:
        """Per-step gradient allreduce over a stage's data-parallel shards
        (two-tier when the stage spans nodes — where the hierarchical
        algorithm pays off)."""
        return self.select(
            self.topology.dp_group(sub_idx, n_nodes, per_node), nbytes)

    def cross_sync(self, sub_idx: int, n_nodes: int, per_node: int,
                   n_clusters: int, nbytes: float) -> Selection:
        """Cross-cluster gradient sync (replicated / shared parameters):
        the group's outermost tier is the shared WAN link, so this is where
        hierarchical reduction and int8 compression earn their keep."""
        return self.select(
            self.topology.cross_group(sub_idx, n_nodes, per_node,
                                      n_clusters), nbytes)

    # -- point-to-point ------------------------------------------------------

    def p2p_latency(self, src_idx: int, dst_idx: int) -> float:
        """Additive per-transfer latency for a stage-boundary send (0 unless
        the boundary crosses the WAN and latency pricing is on)."""
        if not self.cfg.p2p_latency or src_idx == dst_idx:
            return 0.0
        return self.topology.cross_link().latency

    def p2p_seconds(self, nbytes: float, src_idx: int, dst_idx: int) -> float:
        link = self.topology.p2p_link(src_idx, dst_idx)
        return nbytes / link.bandwidth + self.p2p_latency(src_idx, dst_idx)


# ---------------------------------------------------------------------------
# Plan-side accounting (no CommModel needed: reads what the planner recorded)
# ---------------------------------------------------------------------------


def boundary_link_ids(strategy, cluster: HeteroCluster) -> List[str]:
    """Physical link id per stage boundary: the source sub-cluster's
    inter-node fabric within a cluster, the shared ``"wan"`` across — equal
    ids mean the transfers contend in the netsim."""
    out = []
    for i in range(len(strategy.stages) - 1):
        a = strategy.stages[i].cluster_idx
        b = strategy.stages[i + 1].cluster_idx
        out.append(topo_lib.CROSS_LINK if a != b
                   else f"ib:{cluster.subclusters[a].name}")
    return out


def stage_sync_seconds(stage, cluster: HeteroCluster, layers: Sequence,
                       n_microbatches: int) -> float:
    """Per-step data-parallel gradient sync of one stage, with the referee's
    accounting (``runtime.replay.sync_priced_step``): the planner's own
    priced value when the joint search recorded one
    (``IntraOpPlan.sync_time`` is amortized per microbatch, so it scales
    back up by B), else the flat-ring closed form over the stage's dp
    link."""
    io = stage.intra_op
    if io is not None and io.sync_time > 0:
        return io.sync_time * n_microbatches
    if stage.dp <= 1:
        return 0.0
    sub = cluster.subclusters[stage.cluster_idx]
    params = sum(layers[li].param_bytes
                 for li in range(stage.layer_start, stage.layer_end))
    bw = sub.inter_node_bw if stage.mesh_n > 1 else sub.intra_node_bw
    return params * 2 * (stage.dp - 1) / stage.dp / bw


def collective_breakdown(strategy, cluster: HeteroCluster,
                         layers: Sequence) -> Dict:
    """Everything ``Executable.describe()``/``--explain-comm`` and the
    ``LoweredPlan`` collective plan need, computed from a priced strategy:

    - ``stages``: per-stage dicts (algorithms, payload bytes, priced times,
      the links each collective occupies);
    - ``link_ids``: physical link per stage boundary;
    - ``link_occupancy_s``: per physical link, total busy seconds over one
      step (activation sends both directions + TP allreduces + gradient
      syncs) — >1 user on a link is a contended link.

    Intra-op collective occupancy is charged to the collective's bottleneck
    link (the full phase-by-phase split lives in the algorithm costs; the
    bottleneck is what contends)."""
    B = strategy.n_microbatches
    link_ids = boundary_link_ids(strategy, cluster)
    occupancy: Dict[str, float] = {}
    users: Dict[str, int] = {}

    def charge(link: str, seconds: float):
        """One traffic-bearing user of a link; zero-cost collectives carry
        no traffic and neither occupy nor contend."""
        if seconds <= 0:
            return
        occupancy[link] = occupancy.get(link, 0.0) + seconds
        users[link] = users.get(link, 0) + 1

    for i, c in enumerate(strategy.c_links):
        # one boundary = one user, occupying both directions
        charge(link_ids[i], 2 * B * c)

    stages = []
    for si, s in enumerate(strategy.stages):
        sub = cluster.subclusters[s.cluster_idx]
        io = s.intra_op
        intra_id = f"intra:{sub.name}"
        sync_id = f"ib:{sub.name}" if s.mesh_n > 1 else intra_id
        ar_mb = 0.0 if io is None else io.comm_time_f + \
            max(0.0, io.comm_time_b - io.sync_time)
        sync_step = stage_sync_seconds(s, cluster, layers, B)
        charge(intra_id, ar_mb * B)
        charge(sync_id, sync_step)
        stages.append({
            "stage": si,
            "subcluster": sub.name,
            "tp": s.tp, "dp": s.dp,
            "ar_algorithm": None if io is None else io.ar_algo,
            "sync_algorithm": None if io is None else io.sync_algo,
            "sync_compressed": bool(io is not None and io.sync_compressed),
            "comm_bytes": 0.0 if io is None else io.comm_bytes,
            "ar_time_s": ar_mb,             # per microbatch
            "sync_time_s": sync_step,       # per step
            "ar_link": intra_id,
            "sync_link": sync_id,
        })
    contended = sorted(l for l, n in users.items() if n > 1)
    return {"stages": stages, "link_ids": link_ids,
            "link_occupancy_s": occupancy, "contended_links": contended}
