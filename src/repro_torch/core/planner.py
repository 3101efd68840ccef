"""HAPTPlanner: config + cluster -> ParallelStrategy (the paper's Fig. 4 flow).

    ops = build_op_sequence(arch)                  # operator IR
    layers = build_layers(ops, granularity)        # §5.1 structural layers
    tables = ZeroRedundantProfiler(...).profile()  # §5.1 pruned profiles
    strategy = dp_search.search(...)               # §5.2 DP + H-1F1B (§4)

With ``intra_op=True`` the flow becomes the **two-level joint search**: the
profiler emits one table row per (submesh, tensor-parallel width) variant and
the DP chooses the intra-op sharding degree jointly with the inter-op stage
slicing (see docs/planner.md for the full walkthrough).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

from repro_torch.comm.selector import CommConfig, CommModel
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.costmodel import CostModelConfig
from repro_torch.core.dp_search import SearchConfig, search
from repro_torch.core.layering import Layer, build_layers
from repro_torch.core.opgraph import Op, build_op_sequence
from repro_torch.core.profiler import ZeroRedundantProfiler
from repro_torch.core.strategy import ParallelStrategy
from repro_torch.kbench.bridge import KBenchConfig, KBenchModel


@dataclass
class PlannerConfig:
    """Everything :class:`HAPTPlanner` reads.  Units: tokens are counts,
    ``rho`` is the dimensionless imbalance-pruning ratio, all times priced
    downstream are seconds.

    ``intra_op``: run the joint inter+intra-operator search (one DP row per
    (submesh, tp) variant; uneven efficiency-proportional shard ratios in
    mixed sub-clusters; the chosen ``IntraOpPlan`` rides on every stage).
    ``intra_op_max_degree``: prune enumerated tensor-parallel widths to
    ``tp <= intra_op_max_degree`` (0 = unrestricted); dominated variants are
    always eliminated before the DP.
    ``comm``: a :class:`repro_torch.comm.selector.CommConfig` turns on
    heterogeneity-aware collective pricing — the search then chooses plans
    under the per-collective *selected* algorithm's cost (topology-aware
    ring / halving-doubling / two-level hierarchical) and WAN-latency-aware
    cut pricing.  ``None`` (default) keeps the legacy scalar pricing
    bit-identical.
    ``kbench``: a :class:`repro_torch.kbench.bridge.KBenchConfig` turns on
    measured-kernel pricing — the DP search anchors each device's compute
    MFU at the achieved throughput recorded in the latency table (collected
    by ``repro kbench collect``), falling back to the analytic estimate for
    uncovered devices.  ``None`` (default) keeps plans bit-identical.
    """
    granularity: int = 128            # target #layers (fine-grained)
    n_microbatches: int = 128
    microbatch_tokens: int = 0        # 0 -> global_batch_tokens / n_microbatches
    z_heavy: int = 2
    rho: float = 16.0
    min_submesh_devices: int = 1
    max_submesh_devices: int = 0   # 0 = unrestricted
    intra_op: bool = False
    intra_op_max_degree: int = 0   # 0 = unrestricted
    comm: Optional[CommConfig] = None
    kbench: Optional["KBenchConfig"] = None
    cost: CostModelConfig = field(default_factory=CostModelConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    measure_fn: Optional[Callable] = None   # on-hardware profiling hook
                                            # (greedy inter-op path only)


class HAPTPlanner:
    """The offline planner: owns a fleet description and turns an
    architecture into an executable :class:`ParallelStrategy`.

    Invariant: planning never mutates the cluster or the config it was
    constructed with (``plan(intra_op=...)`` overrides are call-scoped), so
    one planner instance can serve many what-if queries — the elastic
    runtime relies on this to probe candidate fleets.
    """

    def __init__(self, cluster: HeteroCluster,
                 cfg: Optional[PlannerConfig] = None):
        self.cluster = cluster
        self.cfg = cfg if cfg is not None else PlannerConfig()

    def plan(self, arch: ArchConfig, *, seq_len: int = 1024,
             global_batch: int = 1024, verbose: bool = False,
             ops: Optional[Sequence[Op]] = None,
             layers: Optional[Sequence[Layer]] = None,
             profile_cache: Optional[Dict] = None,
             intra_op: Optional[bool] = None) -> ParallelStrategy:
        """Search a parallel strategy for ``arch`` on this planner's cluster.

        ``seq_len``/``global_batch`` are token/sample counts; the microbatch
        token budget is ``global_batch * seq_len / n_microbatches`` unless
        ``cfg.microbatch_tokens`` pins it.

        ``profile_cache``: caller-owned cross-invocation stage-cost cache
        (see ZeroRedundantProfiler.cost_cache) — the elastic runtime passes
        one so incremental replans only re-profile changed sub-clusters;
        keys include the intra-op sharding degree, so inter-only and joint
        searches share the cache without collisions.

        ``intra_op``: call-scoped override of ``cfg.intra_op`` (None =
        follow the config) toggling the joint two-level search.
        """
        t0 = time.time()
        cfg = self.cfg
        joint = cfg.intra_op if intra_op is None else intra_op
        B = cfg.n_microbatches
        mb_tokens = cfg.microbatch_tokens or (global_batch * seq_len) // B

        if layers is None:
            if ops is None:
                ops = build_op_sequence(arch, seq_len=seq_len)
            layers = build_layers(ops, cfg.granularity, z=cfg.z_heavy)
        t_layer = time.time()

        comm_model = None
        if cfg.comm is not None and cfg.comm.enabled:
            comm_model = CommModel(self.cluster, cfg.comm)
        kbench_model = None
        if cfg.kbench is not None:
            kbench_model = KBenchModel(cfg.kbench)

        profiler = ZeroRedundantProfiler(
            self.cluster, layers, mb_tokens, cost_cfg=cfg.cost, rho=cfg.rho,
            min_submesh_devices=cfg.min_submesh_devices,
            max_submesh_devices=cfg.max_submesh_devices,
            measure_fn=cfg.measure_fn, cost_cache=profile_cache,
            intra_op=joint, intra_op_max_degree=cfg.intra_op_max_degree,
            amortize_microbatches=B if joint else 0, comm=comm_model,
            kbench=kbench_model)
        tables = profiler.profile()
        t_prof = time.time()

        # call-scoped copy: plan() must not mutate the caller's SearchConfig
        scfg = dataclasses.replace(cfg.search, n_microbatches=B)
        strategy = search(self.cluster, tables, mb_tokens, scfg,
                          verbose=verbose, comm=comm_model)
        t_search = time.time()

        strategy.planner_meta.update({
            "arch": arch.arch_id,
            "granularity": len(layers),
            "seq_len": seq_len,
            "global_batch": global_batch,
            "intra_op": joint,
            "time_layering_s": t_layer - t0,
            "time_profiling_s": t_prof - t_layer,
            "time_search_s": t_search - t_prof,
            "cluster": self.cluster.describe(),
        })
        if comm_model is not None:
            # only comm-aware runs record the comm provenance: the default
            # path's strategy JSON stays bit-identical to the pre-comm
            # pipeline (the DESIGN.md off-state equivalence guarantee)
            strategy.planner_meta["comm"] = dataclasses.asdict(cfg.comm)
        if kbench_model is not None:
            # same off-state rule as comm: only measured-priced runs stamp
            # their provenance (table fingerprint + per-device coverage)
            strategy.planner_meta["kbench"] = {
                "fingerprint": kbench_model.fingerprint(),
                "cells": len(kbench_model.table),
                "covered_devices": sorted(kbench_model.covered_devices()),
            }
        if verbose:
            print(strategy.describe())
        return strategy
