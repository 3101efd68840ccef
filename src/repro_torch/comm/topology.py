"""Typed link graph of a heterogeneous fleet (the comm subsystem's ground
truth).

A :class:`HeteroCluster` flattens the network into three scalar bandwidths
(intra-node, inter-node, cross-cluster); the :class:`Topology` re-expresses
them as *named, tiered links* so collectives can be priced on the link they
actually traverse and concurrent transfers can be attributed to shared
physical capacity:

- ``nvlink`` / ``pcie``  — intra-node fabric, one link per sub-cluster
  (classified by bandwidth: >= :data:`NVLINK_MIN_BW` is NVLink/ICI-class);
- ``ib``                 — inter-node fabric inside one sub-cluster
  (RDMA / pod interconnect);
- ``wan``                — the single cross-cluster link every
  cluster-crossing transfer shares (this sharing is what
  :mod:`repro_torch.comm.netsim` models as contention).

Latency: intra-cluster links are latency-free in the cost model (matching
the legacy scalar pricing exactly); the WAN link carries
``HeteroCluster.cross_latency`` per transfer.

``node_scales`` (from ``SubCluster.node_efficiencies``) ride on the topology
so its :func:`fingerprint` keys every cache that depends on what the comm
model read — two clusters with equal topology fingerprints price every
collective identically.

Units: bandwidths bytes/s per direction, latency seconds.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Tuple

if TYPE_CHECKING:       # typing only: repro_torch.comm must not import repro_torch.core
    from repro_torch.core.cluster import HeteroCluster    # (cycle via planner)

# intra-node fabrics at or above this are NVLink/ICI class; below is PCIe
NVLINK_MIN_BW = 100e9

TIER_NVLINK = "nvlink"
TIER_PCIE = "pcie"
TIER_IB = "ib"
TIER_WAN = "wan"

TIERS = (TIER_NVLINK, TIER_PCIE, TIER_IB, TIER_WAN)

# the id every cross-cluster transfer shares (see module docstring)
CROSS_LINK = "wan"


@dataclass(frozen=True)
class Link:
    """One physical link class: ``name`` is the occupancy key concurrent
    transfers contend on (``netsim``), ``tier`` the semantic class."""
    name: str
    tier: str
    bandwidth: float          # bytes/s per direction
    latency: float = 0.0      # per-transfer startup (s)

    def transfer_seconds(self, nbytes: float) -> float:
        """Point-to-point time for ``nbytes`` at full rate."""
        return nbytes / self.bandwidth + self.latency


@dataclass(frozen=True)
class CommGroup:
    """The participants of one collective, as nested tiers *innermost
    first*: ``tiers[0]`` is the fastest domain (e.g. the ``tp`` ranks inside
    a node), each outer tier multiplies the rank count.  A flat single-tier
    group is the degenerate case every algorithm supports."""
    tiers: Tuple[Tuple[int, Link], ...]   # (domain size, link), innermost first

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("CommGroup needs at least one tier")
        if any(n < 1 for n, _ in self.tiers):
            raise ValueError(f"tier sizes must be >= 1: {self.tiers}")

    @property
    def n_ranks(self) -> int:
        n = 1
        for size, _ in self.tiers:
            n *= size
        return n

    @property
    def bottleneck(self) -> Link:
        """The slowest link in the group (a flat algorithm's pace-setter)."""
        return min((l for _, l in self.tiers), key=lambda l: l.bandwidth)

    @property
    def max_latency(self) -> float:
        return max(l.latency for _, l in self.tiers)

    @property
    def crosses_wan(self) -> bool:
        return any(l.tier == TIER_WAN for _, l in self.tiers)

    def effective(self) -> "CommGroup":
        """The group with degenerate (size-1) tiers dropped — what the
        algorithms actually see.  Fully degenerate groups keep their
        innermost tier (a 1-rank no-op collective)."""
        tiers = tuple((n, l) for n, l in self.tiers if n > 1)
        return CommGroup(tiers or self.tiers[:1])


@dataclass(frozen=True)
class Topology:
    """The fleet's link graph + just enough structure to build groups."""
    subcluster_names: Tuple[str, ...]
    n_nodes: Tuple[int, ...]
    devices_per_node: Tuple[int, ...]
    node_scales: Tuple[Tuple[float, ...], ...]
    links: Tuple[Link, ...]

    def __post_init__(self):
        names = [l.name for l in self.links]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate link names: {names}")

    # -- lookups -------------------------------------------------------------

    def link(self, name: str) -> Link:
        for l in self.links:
            if l.name == name:
                return l
        raise KeyError(f"no link named {name!r}; have "
                       f"{[l.name for l in self.links]}")

    def intra_link(self, sub_idx: int) -> Link:
        return self.link(f"intra:{self.subcluster_names[sub_idx]}")

    def inter_link(self, sub_idx: int) -> Link:
        return self.link(f"ib:{self.subcluster_names[sub_idx]}")

    def cross_link(self) -> Link:
        return self.link(CROSS_LINK)

    def p2p_link(self, src_idx: int, dst_idx: int) -> Link:
        """The link a stage-boundary activation transfer rides: the source
        sub-cluster's inter-node fabric within a cluster, the shared WAN
        across clusters (mirrors ``HeteroCluster.link_bw``)."""
        if src_idx == dst_idx:
            return self.inter_link(src_idx)
        return self.cross_link()

    # -- canonical groups ----------------------------------------------------

    def tp_group(self, sub_idx: int, tp: int) -> CommGroup:
        """Megatron-style tensor-parallel ranks inside one node."""
        return CommGroup(((tp, self.intra_link(sub_idx)),))

    def dp_group(self, sub_idx: int, n_nodes: int, per_node: int) -> CommGroup:
        """A stage's data-parallel shards: ``per_node`` ranks inside each of
        ``n_nodes`` nodes.  Single-node stages collapse to the intra tier."""
        if n_nodes <= 1:
            return CommGroup(((per_node, self.intra_link(sub_idx)),))
        return CommGroup(((per_node, self.intra_link(sub_idx)),
                          (n_nodes, self.inter_link(sub_idx))))

    def cross_group(self, sub_idx: int, n_nodes: int, per_node: int,
                    n_clusters: int) -> CommGroup:
        """A cross-cluster gradient sync (replicated/shared parameters that
        live on stages in ``n_clusters`` different sub-clusters): intra-node
        domain, inter-node domain, then the shared WAN.  Tier links are
        taken from ``sub_idx`` (the hierarchy's local side)."""
        tiers: List[Tuple[int, Link]] = [(per_node, self.intra_link(sub_idx))]
        if n_nodes > 1:
            tiers.append((n_nodes, self.inter_link(sub_idx)))
        tiers.append((n_clusters, self.cross_link()))
        return CommGroup(tuple(tiers))


def build_topology(cluster: "HeteroCluster") -> Topology:
    """The typed link graph of ``cluster``: one intra-node and one
    inter-node link per sub-cluster plus the shared cross-cluster WAN link
    (with the cluster's ``cross_latency``)."""
    links: List[Link] = []
    for sub in cluster.subclusters:
        tier = TIER_NVLINK if sub.intra_node_bw >= NVLINK_MIN_BW else TIER_PCIE
        links.append(Link(f"intra:{sub.name}", tier, sub.intra_node_bw))
        links.append(Link(f"ib:{sub.name}", TIER_IB, sub.inter_node_bw))
    links.append(Link(CROSS_LINK, TIER_WAN, cluster.cross_bw,
                      cluster.cross_latency))
    return Topology(
        subcluster_names=tuple(s.name for s in cluster.subclusters),
        n_nodes=tuple(s.n_nodes for s in cluster.subclusters),
        devices_per_node=tuple(s.devices_per_node
                               for s in cluster.subclusters),
        node_scales=tuple(s.node_scales() for s in cluster.subclusters),
        links=tuple(links))


def fingerprint(topo: Topology) -> str:
    """Stable identity of everything the comm model reads — keys the
    profiler cost cache and the controller's plan cache, alongside
    ``core.cluster.cluster_fingerprint`` (which covers compute)."""
    parts = []
    for i, name in enumerate(topo.subcluster_names):
        scales = ",".join(f"{x:.6g}" for x in topo.node_scales[i])
        parts.append(f"{name}:{topo.n_nodes[i]}x{topo.devices_per_node[i]}"
                     f":[{scales}]")
    for l in topo.links:
        parts.append(f"{l.name}:{l.tier}:{l.bandwidth:.6g}:{l.latency:.6g}")
    return "|".join(parts)
