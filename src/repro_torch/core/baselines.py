"""Baseline planners/schedulers the paper compares against (§6).

- ``plan_uniform``   ("Megatron-like"): equal layer split over fixed
  node-granularity meshes, heterogeneity-blind, classic 1F1B.
- ``plan_coarse``    ("Alpa-like"): HAPT search at coarse granularity
  (#L=8), Eager-1F1B schedule.
- ``plan_coarse_sync`` ("HexiScale-like"): capacity-aware coarse planning
  (#L=48), synchronous sends (no overlap) — simulated with ``no_overlap``.

All reuse the same cost model and simulator so comparisons isolate the
planning/scheduling differences, exactly like the paper's ablations.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.costmodel import CostModelConfig, Submesh, stage_cost
from repro_torch.core.h1f1b import classic_1f1b_counts, eager_1f1b_counts, h1f1b_counts
from repro_torch.core.layering import build_layers
from repro_torch.core.opgraph import build_op_sequence
from repro_torch.core.pipesim import eta_load_balance, simulate
from repro_torch.core.planner import HAPTPlanner, PlannerConfig
from repro_torch.core.strategy import ParallelStrategy, StageAssignment


def plan_uniform(cluster: HeteroCluster, arch: ArchConfig, *, seq_len: int,
                 global_batch: int, n_microbatches: int,
                 cost_cfg: CostModelConfig = CostModelConfig()) -> ParallelStrategy:
    """Megatron-like: one pipeline stage per node, equal layer counts,
    ignoring device heterogeneity.  Fails (raises) when the cluster is not
    expressible as equal-sized node groups — mirroring the paper's Fig. 7(a)
    'unsupported configuration' cases."""
    mb_tokens = (global_batch * seq_len) // n_microbatches
    ops = build_op_sequence(arch, seq_len=seq_len)
    nodes: List[tuple] = []
    for ci, sub in enumerate(cluster.subclusters):
        for _ in range(sub.n_nodes):
            nodes.append((ci, sub.devices_per_node))
    if len({m for _, m in nodes}) != 1:
        raise ValueError("Megatron-like planner requires identical GPUs/node")
    S = len(nodes)
    layers = build_layers(ops, target_layers=S * 4)
    L = len(layers)
    # equal split by layer count
    bounds = [round(i * L / S) for i in range(S + 1)]
    stages, c_links = [], []
    for si in range(S):
        ci, m = nodes[si]
        sub = cluster.subclusters[ci]
        mesh = Submesh(ci, 1, m)
        sl = layers[bounds[si]:bounds[si + 1]]
        sc = stage_cost(sl, sub, mesh, mb_tokens, cost_cfg)
        stages.append(StageAssignment(bounds[si], bounds[si + 1], ci, 1, m,
                                      sc.tp, sc.dp, sc.t_f, sc.t_b,
                                      sc.mem_p, sc.mem_a))
    for si in range(S - 1):
        cut = layers[stages[si].layer_end - 1].act_out_bytes_per_token * mb_tokens
        bw = cluster.link_bw(stages[si].cluster_idx, stages[si + 1].cluster_idx)
        c_links.append(cut / bw)
    counts = classic_1f1b_counts(S, n_microbatches)
    res = simulate([s.t_f for s in stages], [s.t_b for s in stages], c_links,
                   n_microbatches, counts)
    eta = eta_load_balance(
        res.stage_compute,
        [s.n_devices * cluster.subclusters[s.cluster_idx].device.peak_flops
         for s in stages])
    return ParallelStrategy(stages, c_links, counts,
                            max(s.t for s in stages), n_microbatches,
                            mb_tokens, res.makespan, eta,
                            {"baseline": "uniform-1f1b"})


def _planned(cluster, arch, *, seq_len, global_batch, n_microbatches,
             granularity, schedule: str, cost_cfg=CostModelConfig(),
             min_submesh_devices: int = 1) -> ParallelStrategy:
    pcfg = PlannerConfig(granularity=granularity,
                         n_microbatches=n_microbatches, cost=cost_cfg,
                         min_submesh_devices=min_submesh_devices)
    pcfg.search.require_all_devices = True
    try:
        strat = HAPTPlanner(cluster, pcfg).plan(
            arch, seq_len=seq_len, global_batch=global_batch)
    except (RuntimeError, AssertionError):
        pcfg.search.require_all_devices = False
        strat = HAPTPlanner(cluster, pcfg).plan(
            arch, seq_len=seq_len, global_batch=global_batch)
    S = strat.n_stages
    if schedule == "eager":
        counts = eager_1f1b_counts(S, n_microbatches)
    elif schedule == "classic":
        counts = classic_1f1b_counts(S, n_microbatches)
    else:
        counts = strat.warmup_counts
    res = simulate([s.t_f for s in strat.stages], [s.t_b for s in strat.stages],
                   strat.c_links, n_microbatches, counts,
                   no_overlap=(schedule == "sync"))
    strat = replace(strat) if False else strat
    strat.warmup_counts = counts
    strat.est_step_time = res.makespan
    strat.planner_meta["schedule"] = schedule
    return strat


def plan_blind_eager(cluster: HeteroCluster, arch: ArchConfig, *, seq_len: int,
                     global_batch: int, n_microbatches: int,
                     granularity: int = 8,
                     cost_cfg: CostModelConfig = CostModelConfig(),
                     min_submesh_devices: int = 1) -> ParallelStrategy:
    """Alpa-like: heterogeneity-BLIND planning — the planner believes every
    device is the fastest one (Alpa's homogeneous-cluster assumption), then
    the strategy executes on the real mixed hardware.  Reproduces the paper's
    Fig. 8(b): stages landing on slow devices run long (eta ~45%)."""
    import dataclasses as _dc
    fast = max((s.device for s in cluster.subclusters),
               key=lambda d: d.peak_flops)
    blind_cluster = _dc.replace(cluster, subclusters=tuple(
        _dc.replace(s, device=_dc.replace(
            fast, mem_bytes=s.device.mem_bytes))
        for s in cluster.subclusters))
    pcfg = PlannerConfig(granularity=granularity,
                         n_microbatches=n_microbatches, cost=cost_cfg,
                         min_submesh_devices=min_submesh_devices)
    pcfg.search.require_all_devices = True
    try:
        strat = HAPTPlanner(blind_cluster, pcfg).plan(
            arch, seq_len=seq_len, global_batch=global_batch)
    except (RuntimeError, AssertionError):
        pcfg.search.require_all_devices = False
        strat = HAPTPlanner(blind_cluster, pcfg).plan(
            arch, seq_len=seq_len, global_batch=global_batch)
    # re-cost the chosen stages on the REAL devices
    mb_tokens = (global_batch * seq_len) // n_microbatches
    from repro_torch.core.layering import build_layers
    from repro_torch.core.opgraph import build_op_sequence
    layers = build_layers(build_op_sequence(arch, seq_len=seq_len),
                          granularity)
    real_stages = []
    for st in strat.stages:
        sub = cluster.subclusters[st.cluster_idx]
        sc = stage_cost(layers[st.layer_start:st.layer_end], sub,
                        Submesh(st.cluster_idx, st.mesh_n, st.mesh_m),
                        mb_tokens, cost_cfg)
        real_stages.append(StageAssignment(
            st.layer_start, st.layer_end, st.cluster_idx, st.mesh_n,
            st.mesh_m, sc.tp, sc.dp, sc.t_f, sc.t_b, sc.mem_p, sc.mem_a))
    S = len(real_stages)
    counts = eager_1f1b_counts(S, n_microbatches)
    res = simulate([s.t_f for s in real_stages],
                   [s.t_b for s in real_stages], strat.c_links,
                   n_microbatches, counts)
    eta = eta_load_balance(
        res.stage_compute,
        [s.n_devices * cluster.subclusters[s.cluster_idx].device.peak_flops
         for s in real_stages])
    return ParallelStrategy(real_stages, strat.c_links, counts,
                            max(s.t for s in real_stages), n_microbatches,
                            mb_tokens, res.makespan, eta,
                            {"baseline": "blind-eager (Alpa-like)"})


def plan_coarse(cluster, arch, *, seq_len, global_batch, n_microbatches,
                granularity: int = 8, **kw) -> ParallelStrategy:
    """Alpa-like: coarse layers + Eager-1F1B."""
    s = _planned(cluster, arch, seq_len=seq_len, global_batch=global_batch,
                 n_microbatches=n_microbatches, granularity=granularity,
                 schedule="eager", **kw)
    s.planner_meta["baseline"] = "coarse-eager (Alpa-like)"
    return s


def plan_coarse_sync(cluster, arch, *, seq_len, global_batch, n_microbatches,
                     granularity: int = 48, **kw) -> ParallelStrategy:
    """HexiScale-like: capacity-aware coarse planning, no comm overlap."""
    s = _planned(cluster, arch, seq_len=seq_len, global_batch=global_batch,
                 n_microbatches=n_microbatches, granularity=granularity,
                 schedule="sync", **kw)
    s.planner_meta["baseline"] = "coarse-sync (HexiScale-like)"
    return s
