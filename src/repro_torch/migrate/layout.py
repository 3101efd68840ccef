"""Shard-interval layouts: where every parameter/optimizer byte lives
under a plan.

A :class:`PlanLayout` maps each state *leaf* (one planner layer's parameter
block, or its optimizer-state block) to the byte intervals every physical
device holds under a ``(ParallelStrategy, HeteroCluster)`` pair:

- **params** are split into ``tp`` contiguous byte slices (tensor
  parallelism) and replicated across the ``dp`` data shards — every data
  shard holds its tp-slice in full;
- **optimizer state** (ZeRO-1 style, ``opt_bytes_per_param`` x the
  parameter bytes) is additionally sharded across the ``dp`` ranks in
  proportion to the stage's ``IntraOpPlan.shard_ratios`` — the same uneven
  efficiency-proportional split the planner chose for the microbatch, so
  the per-step optimizer update work lands where the compute headroom is.

All splits use exact integer largest-remainder apportionment
(:func:`repro_torch.parallel.sharding.apportion`), which is what makes the
layout differ's transfers reproduce the target layout *bit-identically*
(asserted by the property tests in ``tests/test_migrate.py``).

Device identity is ``(subcluster_name, device_index)``: stages placed on
the same sub-cluster occupy consecutive device ranges in stage order, and
within a stage the flat index follows the ``mesh_from_intra_op`` contract
(``dp_rank * tp + tp_rank``) — so the same physical device is recognized
across two plans and bytes it already holds are never re-shipped.
Node index is ``device_index // devices_per_node`` (link classification:
same node -> ``intra:{name}``, same sub-cluster -> ``ib:{name}``, else the
shared ``wan`` — see ``repro_torch.migrate.pricing``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.layering import Layer
from repro_torch.core.strategy import IntraOpPlan, ParallelStrategy, StageAssignment
from repro_torch.parallel.sharding import apportion

DeviceId = Tuple[str, int]     # (subcluster name, device index within it)
Interval = Tuple[int, int]     # [start, end) in bytes

# ZeRO-1 default: fp32 Adam moments (m, v) alongside the parameters
OPT_BYTES_PER_PARAM = 2.0


@dataclass(frozen=True)
class LeafSpec:
    """One migratable state block: a planner layer's parameters or its
    optimizer state.  ``nbytes`` is the full (unsharded) size."""
    name: str
    nbytes: int
    kind: str                  # "param" | "opt"
    layer: int                 # planner layer index


@dataclass
class PlanLayout:
    """Byte-interval holdings of every device under one plan.

    ``holdings[leaf][device]`` is a sorted, disjoint, non-empty interval
    list; ``leaf_stage[leaf]`` the owning pipeline stage (release ordering
    for the overlap scheduler); ``devices_per_node`` keys link
    classification."""
    leaves: Dict[str, LeafSpec] = field(default_factory=dict)
    holdings: Dict[str, Dict[DeviceId, List[Interval]]] = \
        field(default_factory=dict)
    leaf_stage: Dict[str, int] = field(default_factory=dict)
    devices_per_node: Dict[str, int] = field(default_factory=dict)

    def add(self, spec: LeafSpec, stage: int,
            per_device: Dict[DeviceId, List[Interval]]) -> None:
        if spec.name in self.leaves:
            raise ValueError(f"duplicate leaf {spec.name!r}")
        self.leaves[spec.name] = spec
        self.leaf_stage[spec.name] = stage
        self.holdings[spec.name] = {
            d: ivs for d, ivs in per_device.items() if ivs}

    def node_of(self, dev: DeviceId) -> Tuple[str, int]:
        name, idx = dev
        return (name, idx // self.devices_per_node[name])

    @property
    def total_bytes(self) -> int:
        """Sum of all held bytes across devices (replicas counted)."""
        return sum(e - s for hold in self.holdings.values()
                   for ivs in hold.values() for s, e in ivs)

    def devices(self) -> Set[DeviceId]:
        out: Set[DeviceId] = set()
        for hold in self.holdings.values():
            out.update(hold.keys())
        return out


# ---------------------------------------------------------------------------
# Interval arithmetic (sorted disjoint [start, end) lists)
# ---------------------------------------------------------------------------


def normalize(ivs: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged, empties dropped."""
    out: List[Interval] = []
    for s, e in sorted((s, e) for s, e in ivs if e > s):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    i = j = 0
    a, b = list(a), list(b)
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """Bytes of ``a`` not covered by ``b``."""
    out: List[Interval] = []
    b = list(b)
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def length(ivs: Sequence[Interval]) -> int:
    return sum(e - s for s, e in ivs)


# ---------------------------------------------------------------------------
# Layout construction
# ---------------------------------------------------------------------------


def stage_intra(s: StageAssignment) -> IntraOpPlan:
    """The stage's intra-op plan, or an even degenerate one for inter-only
    strategies (mirrors the api facade's lowering fallback; kept here so
    ``repro_torch.migrate`` does not depend on ``repro_torch.api``)."""
    if s.intra_op is not None:
        return s.intra_op
    tp = max(1, s.tp)
    if s.n_devices % tp != 0:
        tp = 1
    dp = s.n_devices // tp
    return IntraOpPlan(axis="data" if dp >= tp else "tensor", tp=tp, dp=dp,
                       shard_ratios=(1.0 / dp,) * dp,
                       comm_bytes=0.0, comm_time_f=0.0, comm_time_b=0.0)


def stage_devices(strategy: ParallelStrategy, cluster: HeteroCluster
                  ) -> List[List[DeviceId]]:
    """Per stage, the physical devices it occupies: stages sharing a
    sub-cluster take consecutive index ranges in stage order; within a
    stage, flat index ``k`` is data shard ``k // tp``, tp rank ``k % tp``
    (the ``mesh_from_intra_op`` reshape order)."""
    next_free: Dict[str, int] = {}
    out: List[List[DeviceId]] = []
    for s in strategy.stages:
        name = cluster.subclusters[s.cluster_idx].name
        off = next_free.get(name, 0)
        out.append([(name, off + k) for k in range(s.n_devices)])
        next_free[name] = off + s.n_devices
    return out


def layout_from_strategy(strategy: ParallelStrategy, cluster: HeteroCluster,
                         layers: Sequence[Layer], *,
                         opt_bytes_per_param: float = OPT_BYTES_PER_PARAM
                         ) -> PlanLayout:
    """The full shard-interval layout of ``strategy`` on ``cluster``
    (module docstring).  Deterministic: same inputs -> identical layout."""
    lay = PlanLayout(devices_per_node={
        sub.name: sub.devices_per_node for sub in cluster.subclusters})
    devs = stage_devices(strategy, cluster)
    for si, s in enumerate(strategy.stages):
        io = stage_intra(s)
        sdevs = devs[si]
        for li in range(s.layer_start, s.layer_end):
            pb = int(layers[li].param_bytes)
            ob = int(round(pb * opt_bytes_per_param))
            tp_p = apportion(pb, [1.0] * io.tp)
            tp_o = apportion(ob, [1.0] * io.tp)

            # params: tp slice t replicated on every data shard
            hold_p: Dict[DeviceId, List[Interval]] = {}
            off = 0
            for t, sz in enumerate(tp_p):
                if sz > 0:
                    for d in range(io.dp):
                        hold_p[sdevs[d * io.tp + t]] = [(off, off + sz)]
                off += sz
            lay.add(LeafSpec(f"layer{li:04d}.param", pb, "param", li),
                    si, hold_p)

            # optimizer state: each tp slice sharded across dp by the
            # (possibly uneven) shard ratios — no replication
            hold_o: Dict[DeviceId, List[Interval]] = {}
            off = 0
            for t, sz in enumerate(tp_o):
                sub_sizes = apportion(sz, list(io.shard_ratios))
                cur = off
                for d, ssz in enumerate(sub_sizes):
                    if ssz > 0:
                        hold_o[sdevs[d * io.tp + t]] = [(cur, cur + ssz)]
                    cur += ssz
                off += sz
            lay.add(LeafSpec(f"layer{li:04d}.opt", ob, "opt", li), si, hold_o)
    return lay


def lost_devices(old_cluster: HeteroCluster, new_cluster: HeteroCluster
                 ) -> Set[DeviceId]:
    """Devices of ``old_cluster`` that no longer exist in ``new_cluster``
    (sub-cluster shrunk or gone).  ``remove_nodes`` drops *tail* nodes, so
    the lost indices are the tail range — state they held must come from
    surviving replicas or the checkpoint."""
    new_count = {s.name: s.n_devices for s in new_cluster.subclusters}
    lost: Set[DeviceId] = set()
    for sub in old_cluster.subclusters:
        keep = new_count.get(sub.name, 0)
        for i in range(keep, sub.n_devices):
            lost.add((sub.name, i))
    return lost
