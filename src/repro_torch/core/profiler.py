"""Zero-Redundant Profiler (paper §5.1), extended with the joint
inter+intra-operator candidate space.

Enumerates candidate (stage = contiguous layer range) x (submesh) pairs and
collects execution profiles, with the paper's two prunings:

1. *Feasibility pruning*: drop candidates that OOM outright (Eq. 18 with
   K=1) or whose workload share is severely imbalanced w.r.t. the submesh's
   compute-capacity share (ratio outside [1/rho, rho]).
2. *Structural aliasing* ("zero redundancy"): candidates whose layer
   class-key sequences match (ranges spanning identical instances of repeated
   modules) share one profile entry — the profile function is evaluated once
   per unique key.  With an expensive ``measure_fn`` (real hardware) this is
   the paper's >10x profiling saving; the stats are reported either way.

Profiles are materialized as dense numpy tables indexed (mesh_id, i, j) for
the DP search.

**Joint mode** (``intra_op=True``): instead of collapsing each (stage,
submesh) cell to the greedy-cheapest intra-op factorization, the profiler
emits one table *row per (submesh, tensor-parallel width)* — the DP then
chooses the intra-op degree jointly with the stage slicing, trading compute
speed against intra-op collective time and the Eq. 18 activation bound.  Two
extra prunings keep the joint table small:

- ``intra_op_max_degree`` caps the enumerated tp widths;
- *dominated-variant elimination*: a variant row that is nowhere faster,
  nowhere leaner (mem_p, mem_a), and nowhere uniquely feasible than a
  sibling row of the same physical submesh is dropped before the DP.

Cost-cache keys include the sharding degree (``tp``; ``None`` = greedy
inter-only entry), the per-node efficiency mix, and the microbatch
amortization — everything :func:`repro_torch.core.costmodel.intra_op_candidates`
reads.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.costmodel import (
    CostModelConfig, StageCost, Submesh, intra_op_candidates, stage_cost,
)
from repro_torch.core.layering import Layer, layer_class_sequence


@dataclass
class ProfilerStats:
    n_candidates: int = 0
    n_pruned_memory: int = 0
    n_pruned_imbalance: int = 0
    n_unique_profiled: int = 0
    n_aliased: int = 0
    n_cache_hits: int = 0     # hits on a warm cross-invocation cost_cache
    n_variants_dominated: int = 0   # joint rows dropped as dominated

    @property
    def dedup_ratio(self) -> float:
        evaluated = self.n_unique_profiled + self.n_aliased + self.n_cache_hits
        return (self.n_aliased + self.n_cache_hits) / evaluated \
            if evaluated else 0.0


@dataclass
class ProfileTables:
    """Dense DP inputs. meshes[mid] describes column mid of each array.

    In joint mode several rows share one physical submesh;
    ``variant_tp[mid]`` is that row's tensor-parallel width (``None`` for the
    greedy inter-only row)."""
    meshes: List[Submesh]
    t_f: np.ndarray          # (n_mesh, L+1, L+1); [mid, i, j] = stage layers[i:j]
    t_b: np.ndarray
    mem_p: np.ndarray
    mem_a: np.ndarray
    feasible: np.ndarray     # bool, post-pruning
    cut_bytes: np.ndarray    # (L+1,) activation bytes crossing cut at j
    stats: ProfilerStats
    stage_costs: Dict[Tuple[int, int, int], StageCost] = field(default_factory=dict)
    variant_tp: Optional[List[Optional[int]]] = None
    _t_cache: Optional[np.ndarray] = field(default=None, init=False,
                                           repr=False, compare=False)

    @property
    def t(self) -> np.ndarray:
        """Per-stage f+b time, computed once (the planner's hot-path input —
        ``_DPContext`` reads it for every candidate row)."""
        if self._t_cache is None:
            self._t_cache = self.t_f + self.t_b
        return self._t_cache


class ZeroRedundantProfiler:
    def __init__(self, cluster: HeteroCluster, layers: Sequence[Layer],
                 mb_tokens: int, *,
                 cost_cfg: CostModelConfig = CostModelConfig(),
                 rho: float = 16.0,
                 min_submesh_devices: int = 1,
                 max_submesh_devices: int = 0,
                 max_stage_layers: Optional[int] = None,
                 measure_fn: Optional[Callable] = None,
                 cost_cache: Optional[Dict] = None,
                 intra_op: bool = False,
                 intra_op_max_degree: int = 0,
                 amortize_microbatches: int = 0,
                 comm=None, kbench=None):
        """``cost_cache``: a caller-owned stage-cost cache shared ACROSS
        profiler invocations (the elastic runtime's table-reuse API).  Keys
        fingerprint everything the cost model reads — layer-class sequence,
        device profile (incl. calibrated efficiency), per-node efficiency
        mix, link bandwidths, mesh shape, microbatch tokens, cost config,
        and the intra-op sharding degree — so after a fleet change only
        the affected sub-cluster's entries miss; untouched meshes are never
        re-profiled (asserted in tests/test_runtime.py).

        ``intra_op``: emit one table row per (submesh, tp) variant for the
        joint two-level search (see module docstring).
        ``intra_op_max_degree``: cap on enumerated tp widths (0 = all).
        ``amortize_microbatches``: B used to amortize the per-step gradient
        sync into the per-microbatch data-axis cost (0 = don't price it).
        ``comm``: optional :class:`repro_torch.comm.selector.CommModel` — price
        collectives under the selected algorithm (cache keys carry its
        fingerprint so comm-aware and legacy entries never collide).
        ``kbench``: optional :class:`repro_torch.kbench.bridge.KBenchModel` —
        anchor compute MFU at measured kernel throughput (cache keys carry
        its fingerprint too; analytic fallback for uncovered devices)."""
        self.cluster = cluster
        self.layers = list(layers)
        self.mb_tokens = mb_tokens
        self.cost_cfg = cost_cfg
        self.rho = rho
        self.min_submesh = min_submesh_devices
        self.max_submesh = max_submesh_devices
        self.max_stage_layers = max_stage_layers or len(self.layers)
        self.measure_fn = measure_fn
        self.cost_cache = cost_cache if cost_cache is not None else {}
        self.intra_op = intra_op
        self.intra_op_max_degree = intra_op_max_degree
        self.amortize_microbatches = amortize_microbatches
        self.comm = comm
        self.kbench = kbench

    def meshes(self) -> List[Submesh]:
        out = []
        for ci, sub in enumerate(self.cluster.subclusters):
            for (n, m) in sub.submeshes():
                if n * m < self.min_submesh:
                    continue
                if self.max_submesh and n * m > self.max_submesh:
                    continue
                out.append(Submesh(ci, n, m))
        return out

    def _variant_tps(self, mesh: Submesh) -> List[Optional[int]]:
        """Row variants for one physical submesh: tp widths in joint mode,
        the single greedy entry (None) otherwise."""
        if not self.intra_op:
            return [None]
        tps: List[Optional[int]] = []
        tp = 1
        while tp <= mesh.m:
            if mesh.m % tp == 0 and not (self.intra_op_max_degree
                                         and tp > self.intra_op_max_degree):
                tps.append(tp)
            tp *= 2
        return tps or [1]

    def _cell_costs(self, mesh: Submesh, i: int, j: int,
                    tps: Sequence[Optional[int]], stats: ProfilerStats
                    ) -> Dict[Optional[int], StageCost]:
        """Per-variant costs for stage layers[i:j] on ``mesh``, through the
        aliasing / cross-invocation cache."""
        sub = self.cluster.subclusters[mesh.cluster_idx]
        cache = self.cost_cache
        warm = self._warm_keys
        base_key = (layer_class_sequence(self.layers, i, j),
                    sub.device, sub.node_efficiencies,
                    sub.intra_node_bw, sub.inter_node_bw,
                    mesh.n, mesh.m, self.mb_tokens, self.cost_cfg,
                    self.amortize_microbatches if self.intra_op else 0,
                    # sub-scoped comm identity: a fleet change elsewhere must
                    # not evict this sub-cluster's comm-aware entries
                    None if self.comm is None
                    else self.comm.sub_fingerprint(mesh.cluster_idx),
                    # measured-pricing identity: entries priced off a kbench
                    # table must never collide with analytic ones
                    None if self.kbench is None else self.kbench.fingerprint())
        out: Dict[Optional[int], StageCost] = {}
        missing = [tp for tp in tps if (*base_key, tp) not in cache]
        for tp in tps:
            key = (*base_key, tp)
            if key in cache:
                stats.n_cache_hits += 1 if key in warm else 0
                stats.n_aliased += 0 if key in warm else 1
                out[tp] = cache[key]
        if not missing:
            return out
        if self.intra_op:
            cands = {c.tp: c for c in intra_op_candidates(
                self.layers[i:j], sub, mesh, self.mb_tokens, self.cost_cfg,
                uneven=True, amortize_microbatches=self.amortize_microbatches,
                max_degree=self.intra_op_max_degree, comm=self.comm,
                kbench=self.kbench)}
            for tp in missing:
                if tp not in cands:
                    continue
                cache[(*base_key, tp)] = cands[tp]
                out[tp] = cands[tp]
                stats.n_unique_profiled += 1
        else:
            cost = stage_cost(self.layers[i:j], sub, mesh, self.mb_tokens,
                              self.cost_cfg, self.measure_fn, comm=self.comm,
                              kbench=self.kbench)
            cache[(*base_key, None)] = cost
            out[None] = cost
            stats.n_unique_profiled += 1
        return out

    def profile(self) -> ProfileTables:
        L = len(self.layers)
        phys = self.meshes()
        rows: List[Tuple[Submesh, Optional[int]]] = []
        for mesh in phys:
            for tp in self._variant_tps(mesh):
                rows.append((mesh, tp))
        nm = len(rows)
        shape = (nm, L + 1, L + 1)
        t_f = np.full(shape, np.inf)
        t_b = np.full(shape, np.inf)
        mem_p = np.full(shape, np.inf)
        mem_a = np.full(shape, np.inf)
        feas = np.zeros(shape, dtype=bool)
        stats = ProfilerStats()
        self._warm_keys = frozenset(self.cost_cache)  # cross-invocation
        stage_costs: Dict[Tuple[int, int, int], StageCost] = {}

        total_flops = sum(l.flops_per_token for l in self.layers) or 1.0
        total_peak = sum(s.n_devices * s.device.effective_flops
                         for s in self.cluster.subclusters)

        # prefix sums for fast share computation
        pre_flops = np.zeros(L + 1)
        for i, l in enumerate(self.layers):
            pre_flops[i + 1] = pre_flops[i] + l.flops_per_token

        # row ids of each physical mesh (for cell-cost sharing + domination)
        groups: Dict[int, List[int]] = {}
        for mid, (mesh, tp) in enumerate(rows):
            groups.setdefault(phys.index(mesh), []).append(mid)

        for pid, mesh in enumerate(phys):
            sub = self.cluster.subclusters[mesh.cluster_idx]
            mids = groups[pid]
            tps = [rows[mid][1] for mid in mids]
            cap_share = mesh.n_devices * sub.device.effective_flops / total_peak
            for i in range(L):
                jmax = min(L, i + self.max_stage_layers)
                for j in range(i + 1, jmax + 1):
                    stats.n_candidates += 1
                    work_share = (pre_flops[j] - pre_flops[i]) / total_flops
                    if work_share > self.rho * cap_share:
                        stats.n_pruned_imbalance += 1
                        continue
                    costs = self._cell_costs(mesh, i, j, tps, stats)
                    for mid, tp in zip(mids, tps):
                        cost = costs.get(tp)
                        if cost is None:
                            continue
                        # memory pruning at the loosest warm-up (K=1)
                        if cost.mem_p + cost.mem_a > sub.device.mem_bytes:
                            stats.n_pruned_memory += 1
                            continue
                        t_f[mid, i, j] = cost.t_f
                        t_b[mid, i, j] = cost.t_b
                        mem_p[mid, i, j] = cost.mem_p
                        mem_a[mid, i, j] = cost.mem_a
                        feas[mid, i, j] = True
                        stage_costs[(mid, i, j)] = cost

        if self.intra_op:
            keep = self._prune_dominated(groups, t_f, t_b, mem_p, mem_a,
                                         feas, stats)
            remap = {old: new for new, old in enumerate(keep)}
            rows = [rows[mid] for mid in keep]
            t_f, t_b = t_f[keep], t_b[keep]
            mem_p, mem_a = mem_p[keep], mem_a[keep]
            feas = feas[keep]
            stage_costs = {(remap[mid], i, j): c
                           for (mid, i, j), c in stage_costs.items()
                           if mid in remap}

        cut_bytes = np.zeros(L + 1)
        for j in range(1, L):
            cut_bytes[j] = self.layers[j - 1].act_out_bytes_per_token * self.mb_tokens

        return ProfileTables([mesh for mesh, _ in rows],
                             t_f, t_b, mem_p, mem_a, feas, cut_bytes,
                             stats, stage_costs,
                             variant_tp=[tp for _, tp in rows])

    @staticmethod
    def _prune_dominated(groups: Dict[int, List[int]], t_f, t_b, mem_p,
                         mem_a, feas, stats: ProfilerStats) -> List[int]:
        """Joint-mode row pruning: within one physical submesh, drop variant
        r2 when a sibling r1 is feasible everywhere r2 is, and there no
        slower / no more memory-hungry (r1 dominates r2)."""
        t = t_f + t_b
        keep: List[int] = []
        for mids in groups.values():
            dropped = set()
            for r2 in mids:
                f2 = feas[r2]
                if not f2.any():
                    dropped.add(r2)      # nowhere feasible: dead row
                    continue
                for r1 in mids:
                    if r1 == r2 or r1 in dropped:
                        continue
                    if not np.all(feas[r1][f2]):
                        continue
                    if (np.all(t[r1][f2] <= t[r2][f2] + 1e-15)
                            and np.all(mem_a[r1][f2] <= mem_a[r2][f2] + 1e-9)
                            and np.all(mem_p[r1][f2] <= mem_p[r2][f2] + 1e-9)):
                        dropped.add(r2)
                        stats.n_variants_dominated += 1
                        break
            keep.extend(mid for mid in mids if mid not in dropped)
        return sorted(keep)
