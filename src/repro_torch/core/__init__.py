from repro_torch.core.cluster import (
    DeviceProfile, HeteroCluster, SubCluster,
    add_nodes, cluster_fingerprint, heterogeneous_tpu_cluster,
    homogeneous_cluster, paper_case_study_cluster, paper_eval_cluster,
    remove_nodes, set_efficiency, set_node_efficiencies, subcluster_index,
    tpu_multipod_cluster, with_cross_bw,
)
from repro_torch.core.h1f1b import (
    classic_1f1b_counts, eager_1f1b_counts, h1f1b_counts, h1f1b_deltas,
)
from repro_torch.core.planner import HAPTPlanner, PlannerConfig
from repro_torch.core.pipesim import ascii_timeline, eta_load_balance, simulate
from repro_torch.core.strategy import IntraOpPlan, ParallelStrategy, StageAssignment

__all__ = [
    "DeviceProfile", "HeteroCluster", "SubCluster", "HAPTPlanner",
    "PlannerConfig", "ParallelStrategy", "StageAssignment", "IntraOpPlan",
    "set_node_efficiencies",
    "simulate", "ascii_timeline", "eta_load_balance",
    "h1f1b_counts", "h1f1b_deltas", "classic_1f1b_counts",
    "eager_1f1b_counts", "paper_case_study_cluster", "paper_eval_cluster",
    "homogeneous_cluster", "tpu_multipod_cluster", "heterogeneous_tpu_cluster",
    "add_nodes", "remove_nodes", "with_cross_bw", "set_efficiency",
    "subcluster_index", "cluster_fingerprint",
]
