"""Heterogeneous cluster description.

The paper's abstraction: a heterogeneous cluster = several *homogeneous
sub-clusters* (``DeviceMesh(N, M)`` each), fast links inside a sub-cluster,
slow links across.  TPU mapping: sub-cluster = pod; fast link = ICI; slow
link = DCN.  All bandwidths in bytes/s, compute in FLOP/s, memory in bytes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

GBPS = 1e9 / 8          # 1 Gbps in bytes/s
GB = 1024 ** 3


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    peak_flops: float            # per device, half precision
    mem_bytes: float
    hbm_bw: float                # bytes/s
    base_mfu: float = 0.5        # achievable model-flop utilization at TP=1
    efficiency: float = 1.0      # runtime calibration scale (1.0 = as-specced;
                                 # <1 = straggling/thermal-throttled hardware)

    @property
    def effective_flops(self) -> float:
        return self.peak_flops * self.efficiency


# Published specs (paper Table 2 + TPU targets)
A100_40G = DeviceProfile("A100-40G", 312e12, 40 * GB, 1555e9, base_mfu=0.50)
V100_32G = DeviceProfile("V100-32G", 125e12, 32 * GB, 900e9, base_mfu=0.45)
TPU_V5E = DeviceProfile("TPUv5e", 197e12, 16 * GB, 819e9, base_mfu=0.55)
TPU_V4 = DeviceProfile("TPUv4", 275e12, 32 * GB, 1228e9, base_mfu=0.55)
# The port's card (NVIDIA H100 SXM data sheet): 989 TFLOP/s dense bf16,
# 3.35 TB/s HBM3.  base_mfu stays at the default: a kbench table measured on
# the card replaces it (kbench/bridge.py)
H100_80G = DeviceProfile("H100-80G", 989e12, 80 * GB, 3.35e12)

# Named registry of the canonical profiles (also exposed through
# repro.api.registry under kind "device") — benchmarks/roofline.py and the
# kbench CLI resolve fleet devices by name here instead of hardcoding specs.
DEVICE_PROFILES: Dict[str, DeviceProfile] = {
    p.name: p for p in (A100_40G, V100_32G, TPU_V5E, TPU_V4, H100_80G)
}

# Typical per-device interconnect bandwidth (bytes/s per direction) for
# roofline-style comm bounds: NVLink-gen for the GPUs, ICI for the TPUs.
DEVICE_LINK_BW: Dict[str, float] = {
    "A100-40G": 300e9,
    "V100-32G": 150e9,
    "TPUv5e": 4 * 50e9,
    "TPUv4": 4 * 50e9,
    "H100-80G": 450e9,            # NVLink 4: 900 GB/s, 450 each way
}


@dataclass(frozen=True)
class SubCluster:
    """One DeviceMesh(N, M): N nodes x M devices sharing one DeviceProfile.

    ``node_efficiencies`` (optional, len == ``n_nodes``) makes the sub-cluster
    *mixed*: entry ``i`` is a per-node multiplier on ``device.efficiency``
    (1.0 = as-specced; 0.7 = a node running at 70% of its siblings).  The
    joint planner exploits the mix with uneven intra-op shard ratios; the
    inter-op-only planner is bottlenecked by the slowest node (``min``).
    All bandwidths are bytes/s per direction.
    """
    name: str
    n_nodes: int
    devices_per_node: int
    device: DeviceProfile
    intra_node_bw: float          # NVLink / intra-host ICI (bytes/s, per dir)
    inter_node_bw: float          # RDMA / pod fabric (bytes/s)
    node_efficiencies: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        ne = self.node_efficiencies
        if ne is not None:
            if len(ne) != self.n_nodes:
                raise ValueError(
                    f"{self.name}: node_efficiencies has {len(ne)} entries "
                    f"for {self.n_nodes} nodes")
            if any(e <= 0 for e in ne):
                raise ValueError("node efficiencies must be positive")

    @property
    def n_devices(self) -> int:
        return self.n_nodes * self.devices_per_node

    def node_scales(self, n_nodes: Optional[int] = None) -> Tuple[float, ...]:
        """Per-node efficiency multipliers for a submesh of ``n_nodes`` nodes
        (all nodes when None).  Homogeneous -> all 1.0.  A partial submesh is
        priced on the *slowest* nodes: the scheduler cannot promise the fast
        ones, so plans must be robust to worst-case placement — recovering a
        mixed fleet's capacity is the uneven intra-op sharding's job, not an
        optimistic placement assumption's."""
        n = self.n_nodes if n_nodes is None else n_nodes
        if self.node_efficiencies is None:
            return (1.0,) * n
        return tuple(sorted(self.node_efficiencies)[:n])

    @property
    def peak_flops(self) -> float:
        return self.n_devices * self.device.peak_flops

    def submeshes(self) -> List[Tuple[int, int]]:
        """Alpa's submesh shapes: (1,1),(1,2),...,(1,M), (2,M),...,(N,M)."""
        out = []
        m = 1
        while m <= self.devices_per_node:
            out.append((1, m))
            m *= 2
        if self.devices_per_node not in [s[1] for s in out]:
            out.append((1, self.devices_per_node))
        for n in range(2, self.n_nodes + 1):
            out.append((n, self.devices_per_node))
        return out


@dataclass(frozen=True)
class HeteroCluster:
    subclusters: Tuple[SubCluster, ...]
    cross_bw: float               # slow cross-cluster link (bytes/s)
    cross_latency: float = 1e-3   # per-transfer latency (s)

    @property
    def n_devices(self) -> int:
        return sum(s.n_devices for s in self.subclusters)

    @property
    def peak_flops(self) -> float:
        return sum(s.peak_flops for s in self.subclusters)

    def link_bw(self, src: int, dst: int) -> float:
        """Bandwidth between stages on subclusters ``src`` and ``dst``."""
        if src == dst:
            return self.subclusters[src].inter_node_bw
        return self.cross_bw

    def describe(self) -> str:
        parts = [
            f"{s.name}: {s.n_nodes}x{s.devices_per_node} {s.device.name} "
            f"({s.peak_flops/1e12:.0f} TF)" for s in self.subclusters]
        return " + ".join(parts) + f" | cross {self.cross_bw*8/1e9:.0f} Gbps"


# ---------------------------------------------------------------------------
# Canonical clusters
# ---------------------------------------------------------------------------


def paper_case_study_cluster(cross_gbps: float = 5.0) -> HeteroCluster:
    """§2.2.2: DeviceMesh_A100(2,2) + DeviceMesh_V100(1,2), 5 Gbps cross."""
    return HeteroCluster(
        subclusters=(
            SubCluster("meshA100", 2, 2, A100_40G, 300e9, 200 * GBPS),
            SubCluster("meshV100", 1, 2, V100_32G, 150e9, 200 * GBPS),
        ),
        cross_bw=cross_gbps * GBPS)


def paper_eval_cluster(n_a100_nodes: int = 4, n_v100_nodes: int = 4,
                       gpus_per_node: int = 8,
                       cross_gbps: float = 5.0) -> HeteroCluster:
    """§6: up to 4 nodes x 8 A100 + 4 nodes x 8 V100 (ShanHe)."""
    return HeteroCluster(
        subclusters=(
            SubCluster("A100", n_a100_nodes, gpus_per_node, A100_40G,
                       300e9, 200 * GBPS),
            SubCluster("V100", n_v100_nodes, gpus_per_node, V100_32G,
                       150e9, 200 * GBPS),
        ),
        cross_bw=cross_gbps * GBPS)


def homogeneous_cluster(n_nodes: int = 8, gpus_per_node: int = 8,
                        device: DeviceProfile = A100_40G) -> HeteroCluster:
    """§6.2 baseline: fully-connected homogeneous cluster (200 Gbps RDMA)."""
    return HeteroCluster(
        subclusters=(SubCluster("homo", n_nodes, gpus_per_node, device,
                                300e9, 200 * GBPS),),
        cross_bw=200 * GBPS)


def tpu_multipod_cluster(n_pods: int = 2, pod_side: Tuple[int, int] = (16, 16),
                         device: DeviceProfile = TPU_V5E,
                         dcn_gbps: float = 100.0) -> HeteroCluster:
    """The production target: v5e pods joined by DCN. One sub-cluster per
    pod; intra-pod "node" = one ICI-connected row (model axis)."""
    n, m = pod_side
    subs = tuple(
        SubCluster(f"pod{i}", n, m, device, 4 * 50e9, 3 * 50e9)
        for i in range(n_pods))
    return HeteroCluster(subclusters=subs, cross_bw=dcn_gbps * GBPS)


# ---------------------------------------------------------------------------
# Mutation helpers (elastic runtime): HeteroCluster is frozen, so every fleet
# change produces a new value via dataclasses.replace.  All helpers address
# sub-clusters by *name* — indices shift when a sub-cluster disappears.
# ---------------------------------------------------------------------------


def subcluster_index(cluster: HeteroCluster, name: str) -> int:
    for i, s in enumerate(cluster.subclusters):
        if s.name == name:
            return i
    raise KeyError(f"no sub-cluster named {name!r} in {cluster.describe()}")


def _replace_subcluster(cluster: HeteroCluster, name: str,
                        new: SubCluster | None) -> HeteroCluster:
    idx = subcluster_index(cluster, name)
    subs = list(cluster.subclusters)
    if new is None:
        del subs[idx]
    else:
        subs[idx] = new
    if not subs:
        raise ValueError("cluster would have no sub-clusters left")
    return dataclasses.replace(cluster, subclusters=tuple(subs))


def remove_nodes(cluster: HeteroCluster, name: str, n: int = 1) -> HeteroCluster:
    """Node failure / preemption: ``name`` loses ``n`` nodes (the whole
    sub-cluster is dropped when none remain)."""
    idx = subcluster_index(cluster, name)
    sub = cluster.subclusters[idx]
    if n > sub.n_nodes:
        raise ValueError(
            f"{name} has {sub.n_nodes} nodes, cannot remove {n}")
    if n == sub.n_nodes:
        return _replace_subcluster(cluster, name, None)
    ne = sub.node_efficiencies
    return _replace_subcluster(
        cluster, name, dataclasses.replace(
            sub, n_nodes=sub.n_nodes - n,
            node_efficiencies=None if ne is None else ne[:sub.n_nodes - n]))


def add_nodes(cluster: HeteroCluster, name: str, n: int = 1) -> HeteroCluster:
    """Node (re)join: ``name`` gains ``n`` nodes of its existing profile
    (joining nodes start at nominal per-node efficiency 1.0)."""
    idx = subcluster_index(cluster, name)
    sub = cluster.subclusters[idx]
    ne = sub.node_efficiencies
    return _replace_subcluster(
        cluster, name, dataclasses.replace(
            sub, n_nodes=sub.n_nodes + n,
            node_efficiencies=None if ne is None else ne + (1.0,) * n))


def with_cross_bw(cluster: HeteroCluster, cross_bw: float) -> HeteroCluster:
    """Cross-cluster bandwidth shift (bytes/s)."""
    if cross_bw <= 0:
        raise ValueError("cross_bw must be positive")
    return dataclasses.replace(cluster, cross_bw=cross_bw)


def set_efficiency(cluster: HeteroCluster, name: str,
                   efficiency: float) -> HeteroCluster:
    """Absolute runtime-calibration efficiency for one sub-cluster's device."""
    if efficiency <= 0:
        raise ValueError("efficiency must be positive")
    idx = subcluster_index(cluster, name)
    sub = cluster.subclusters[idx]
    dev = dataclasses.replace(sub.device, efficiency=efficiency)
    return _replace_subcluster(
        cluster, name, dataclasses.replace(sub, device=dev))


def set_node_efficiencies(cluster: HeteroCluster, name: str,
                          efficiencies: Optional[Sequence[float]]
                          ) -> HeteroCluster:
    """Per-node efficiency multipliers for one sub-cluster (length must equal
    its node count; None restores homogeneity).  This is how a *mixed*
    sub-cluster — some nodes throttled, some nominal — enters the planner."""
    idx = subcluster_index(cluster, name)
    sub = cluster.subclusters[idx]
    ne = None if efficiencies is None else tuple(float(e) for e in efficiencies)
    return _replace_subcluster(
        cluster, name, dataclasses.replace(sub, node_efficiencies=ne))


def set_inter_node_bw(cluster: HeteroCluster, name: str,
                      inter_node_bw: float) -> HeteroCluster:
    """Recalibrated inter-node fabric bandwidth for one sub-cluster
    (bytes/s) — the comm telemetry's per-tier analogue of
    :func:`with_cross_bw`."""
    if inter_node_bw <= 0:
        raise ValueError("inter_node_bw must be positive")
    idx = subcluster_index(cluster, name)
    sub = cluster.subclusters[idx]
    return _replace_subcluster(
        cluster, name, dataclasses.replace(sub, inter_node_bw=inter_node_bw))


def cluster_fingerprint(cluster: HeteroCluster) -> str:
    """Stable identity of everything the planner's cost model reads — used to
    key plan caches (two clusters with equal fingerprints plan identically)."""
    parts = []
    for s in cluster.subclusters:
        d = s.device
        ne = "" if s.node_efficiencies is None else \
            ":" + ",".join(f"{e:.6g}" for e in s.node_efficiencies)
        parts.append(f"{s.name}:{s.n_nodes}x{s.devices_per_node}"
                     f":{d.name}:{d.peak_flops:.6g}:{d.mem_bytes:.6g}"
                     f":{d.base_mfu:.6g}:{d.efficiency:.6g}"
                     f":{s.intra_node_bw:.6g}:{s.inter_node_bw:.6g}{ne}")
    parts.append(f"cross:{cluster.cross_bw:.6g}:{cluster.cross_latency:.6g}")
    return "|".join(parts)


# ---------------------------------------------------------------------------
# (De)serialization — plain JSON-native dicts.  Lives here (not in repro.api)
# so the runtime's plan cache and the chaos trace format can round-trip fleet
# specs without importing the api layer; ``repro.api.artifacts`` re-exports.
# ---------------------------------------------------------------------------


def subcluster_to_dict(sub: SubCluster) -> Dict:
    """One sub-cluster spec as JSON-native data (tuples become lists)."""
    import json as _json
    return _json.loads(_json.dumps(dataclasses.asdict(sub)))


def subcluster_from_dict(d: Dict) -> SubCluster:
    d = dict(d)
    dev = DeviceProfile(**d.pop("device"))
    ne = d.pop("node_efficiencies", None)
    return SubCluster(device=dev,
                      node_efficiencies=None if ne is None else tuple(ne), **d)


def cluster_to_dict(cluster: HeteroCluster) -> Dict:
    """Full fleet spec as plain JSON-native data (everything the cost model
    reads; tuples normalized to lists so artifact dicts are pure JSON)."""
    import json as _json
    return _json.loads(_json.dumps(dataclasses.asdict(cluster)))


def cluster_from_dict(d: Dict) -> HeteroCluster:
    subs = tuple(subcluster_from_dict(sd) for sd in d["subclusters"])
    return HeteroCluster(subclusters=subs, cross_bw=d["cross_bw"],
                         cross_latency=d.get("cross_latency", 1e-3))


def heterogeneous_tpu_cluster(dcn_gbps: float = 100.0) -> HeteroCluster:
    """A mixed-generation TPU fleet (v5e pod + v4 pod) — the TPU analogue of
    the paper's A100+V100 setting."""
    return HeteroCluster(
        subclusters=(
            SubCluster("v5e-pod", 16, 16, TPU_V5E, 4 * 50e9, 3 * 50e9),
            SubCluster("v4-pod", 8, 16, TPU_V4, 4 * 50e9, 3 * 50e9),
        ),
        cross_bw=dcn_gbps * GBPS)
