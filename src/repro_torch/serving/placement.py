"""Disaggregated prefill/decode placement search over the fleet's pools.

Each sub-cluster of the :class:`HeteroCluster` is a candidate *pool*
holding a full replica of the model (TP/DP inside the pool, no pipeline —
serving replicas are latency-bound, not capacity-bound like training).  A
placement assigns every pool a role:

- ``prefill`` — runs prompt prefill only (compute-bound: suits the
  high-FLOPs sub-clusters);
- ``decode``  — runs token decode only (HBM-bandwidth/KV-capacity-bound:
  suits the memory-rich stragglers);
- ``mixed``   — both, interleaved (the colocated baseline's role, with the
  prefill-decode interference that implies);
- ``off``     — not used (e.g. the weights don't fit).

The search enumerates role assignments, prices each pool with the training
stack's machinery — prefill chunk time via ``core.costmodel.stage_cost``
through the *profiler's cost-cache key recipe* (entries are shared with
training planner runs on the same fleet), decode step time from an HBM/FLOPs
roofline, KV capacity from :mod:`repro_torch.serving.kvplan` — prices the
prefill→decode KV handoff through :mod:`repro_torch.comm`'s tiered links, then
simulates each candidate on a sample of the trace
(:mod:`repro_torch.serving.batching`) and keeps the best under the configured
objective.  The colocated-uniform baseline (all pools ``mixed``,
round-robin routing) is always simulated for comparison and recorded on
``ServePlan.baseline``.

No jax imports: serving plans are searchable on a CPU-only planning box
and ship as the ``serve`` section of the schema-v4 Plan artifact.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.comm.selector import CommModel
from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import HeteroCluster
from repro_torch.core.costmodel import CostModelConfig, Submesh, stage_cost
from repro_torch.core.layering import Layer, build_layers, layer_class_sequence
from repro_torch.core.opgraph import build_op_sequence
from repro_torch.serving import kvplan
from repro_torch.serving.objective import OBJECTIVES, better, score
from repro_torch.serving.workload import ServeTrace, poisson_trace

SERVE_SCHEMA_VERSION = 1

ROLES = ("prefill", "decode", "mixed", "off")

# process-wide stage-cost cache for serving searches (callers may pass the
# elastic runtime's cache instead; keys follow the profiler's recipe, so
# entries interoperate)
_COST_CACHE: Dict = {}


@dataclass
class ServingConfig:
    """Everything the serving planner reads (JSON-native scalars only —
    rides inside :class:`~repro_torch.api.config.HarpConfig`).

    Workload: ``qps``/``duration_s``/``seed`` parameterize the default
    Poisson trace; ``prompt_mean``/``output_mean`` its length marginals.
    Objective: ``"slo"`` (meet p99 TTFT/TPOT targets, see
    :mod:`repro_torch.serving.objective`) or ``"throughput"`` (max goodput).
    KV: cache dtype width, paged-block granularity, memory headroom.
    Batching: prefill chunk tokens, per-pool admission queue bound,
    decode-step dispatch overhead, and the decode MFU derate (decode GEMVs
    reach a fraction of ``base_mfu``).  ``search_sample`` caps the requests
    simulated per placement candidate during the search."""
    qps: float = 32.0
    duration_s: float = 2.0
    seed: int = 0
    prompt_mean: int = 512
    output_mean: int = 64
    objective: str = "slo"
    slo_ttft_s: float = 0.2
    slo_tpot_s: float = 0.02
    kv_dtype_bytes: float = 2.0
    block_tokens: int = 16
    prefill_chunk: int = 256
    max_queue: int = 128
    mem_headroom: float = 0.9
    decode_mfu: float = 0.6
    step_overhead_s: float = 2e-4
    search_sample: int = 512

    def validate_errors(self) -> List[str]:
        errs = []
        if self.qps <= 0:
            errs.append(f"serving.qps must be positive, got {self.qps}")
        if self.duration_s <= 0:
            errs.append(f"serving.duration_s must be positive, "
                        f"got {self.duration_s}")
        if self.objective not in OBJECTIVES:
            errs.append(f"unknown serving.objective {self.objective!r}; "
                        f"one of {OBJECTIVES}")
        if self.prompt_mean <= 0 or self.output_mean <= 0:
            errs.append("serving prompt_mean/output_mean must be positive")
        if self.block_tokens <= 0:
            errs.append(f"serving.block_tokens must be positive, "
                        f"got {self.block_tokens}")
        if self.prefill_chunk <= 0:
            errs.append(f"serving.prefill_chunk must be positive, "
                        f"got {self.prefill_chunk}")
        if not 0.0 < self.mem_headroom <= 1.0:
            errs.append(f"serving.mem_headroom must be in (0, 1], "
                        f"got {self.mem_headroom}")
        if self.slo_ttft_s <= 0 or self.slo_tpot_s <= 0:
            errs.append("serving SLO targets must be positive")
        return errs


@dataclass(frozen=True)
class PoolSpec:
    """One priced pool: role + capacity + the three rates the batching
    simulator reads (chunk prefill time, aggregate HBM bandwidth, aggregate
    decode FLOPs)."""
    name: str
    cluster_idx: int
    role: str                    # 'prefill' | 'decode' | 'mixed'
    n_devices: int
    weights_bytes: float
    block_bytes: float
    blocks_capacity: int
    prefill_chunk_s: float       # seconds per prefill chunk (full pool)
    hbm_bytes_per_s: float       # aggregate effective HBM bandwidth
    decode_flops_per_s: float    # aggregate effective decode FLOP/s

    @property
    def can_prefill(self) -> bool:
        return self.role in ("prefill", "mixed")

    @property
    def can_decode(self) -> bool:
        return self.role in ("decode", "mixed")


@dataclass
class ServePlan:
    """The serving artifact: priced pools + handoff links + the constants
    the simulator needs, JSON round-trippable (``serve`` section of the
    schema-v4 Plan)."""
    arch: str
    objective: str
    routing: str                       # 'least_loaded' | 'uniform'
    prefill_chunk: int                 # tokens per prefill chunk
    block_tokens: int
    kv_bytes_per_token: float
    state_bytes_per_seq: float
    flops_per_token: float             # model forward FLOPs per token
    step_overhead_s: float
    max_queue: int
    slo_ttft_s: float
    slo_tpot_s: float
    pools: List[PoolSpec]
    handoff_bw: Dict[str, float] = field(default_factory=dict)
    handoff_latency: Dict[str, float] = field(default_factory=dict)
    predicted: Dict[str, Any] = field(default_factory=dict)
    baseline: Dict[str, Any] = field(default_factory=dict)
    version: int = SERVE_SCHEMA_VERSION

    # -- handoff pricing -----------------------------------------------------

    def handoff_seconds(self, src: int, dst: int, nbytes: float) -> float:
        """KV-cache shipping time from pool ``src`` to pool ``dst`` over the
        priced link (0 when prefill and decode share the pool)."""
        if src == dst:
            return 0.0
        key = f"{src}->{dst}"
        return nbytes / self.handoff_bw[key] + self.handoff_latency[key]

    def seq_blocks(self, seq_tokens: int) -> int:
        """Paged-block reservation for ``seq_tokens`` of context (mirrors
        :func:`repro_torch.serving.kvplan.blocks_for_seq` using the plan's frozen
        constants — the artifact must not re-derive from the arch)."""
        import math
        if self.kv_bytes_per_token <= 0:
            return 1
        kv_blocks = math.ceil(seq_tokens / self.block_tokens)
        if self.state_bytes_per_seq <= 0:
            return kv_blocks
        bb = self.block_tokens * self.kv_bytes_per_token
        return kv_blocks + math.ceil(self.state_bytes_per_seq / bb)

    def seq_kv_bytes(self, seq_tokens: int) -> float:
        return seq_tokens * self.kv_bytes_per_token + self.state_bytes_per_seq

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "arch": self.arch,
            "objective": self.objective,
            "routing": self.routing,
            "prefill_chunk": self.prefill_chunk,
            "block_tokens": self.block_tokens,
            "kv_bytes_per_token": self.kv_bytes_per_token,
            "state_bytes_per_seq": self.state_bytes_per_seq,
            "flops_per_token": self.flops_per_token,
            "step_overhead_s": self.step_overhead_s,
            "max_queue": self.max_queue,
            "slo_ttft_s": self.slo_ttft_s,
            "slo_tpot_s": self.slo_tpot_s,
            "pools": [dataclasses.asdict(p) for p in self.pools],
            "handoff_bw": dict(self.handoff_bw),
            "handoff_latency": dict(self.handoff_latency),
            "predicted": self.predicted,
            "baseline": self.baseline,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServePlan":
        d = dict(d)
        version = d.pop("version", SERVE_SCHEMA_VERSION)
        pools = [PoolSpec(**p) for p in d.pop("pools")]
        return ServePlan(pools=pools, version=version, **d)

    def describe(self) -> str:
        lines = [f"ServePlan[{self.arch}] objective={self.objective} "
                 f"routing={self.routing}"]
        for i, p in enumerate(self.pools):
            extra = ""
            if p.can_decode:
                extra = f", {p.blocks_capacity} KV blocks"
            lines.append(
                f"  pool{i} [{p.name}] role={p.role}: "
                f"{p.n_devices} dev, prefill chunk "
                f"{p.prefill_chunk_s * 1e3:.2f} ms{extra}")
        pred = self.predicted
        if pred:
            lines.append(
                f"  predicted: p99 TTFT {pred.get('p99_ttft_s', 0) * 1e3:.1f}"
                f" ms, p99 TPOT {pred.get('p99_tpot_s', 0) * 1e3:.2f} ms, "
                f"goodput {pred.get('goodput_tokens_per_s', 0):,.0f} tok/s")
        base = self.baseline
        if base:
            lines.append(
                f"  colocated-uniform baseline: p99 TTFT "
                f"{base.get('p99_ttft_s', 0) * 1e3:.1f} ms, goodput "
                f"{base.get('goodput_tokens_per_s', 0):,.0f} tok/s")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Pool pricing
# ---------------------------------------------------------------------------


def serving_layers(arch_cfg: ArchConfig, scfg: ServingConfig,
                   granularity: int = 0) -> List[Layer]:
    """The planner IR at the workload's representative context length
    (prompt + output): attention cost must be priced at serving context,
    not the training seq_len."""
    ctx = max(1, scfg.prompt_mean + scfg.output_mean)
    ops = build_op_sequence(arch_cfg, seq_len=ctx)
    # coarse layering: pool pricing only reads stage *sums*, so a small
    # target keeps the cost-cache key short
    return build_layers(ops, granularity or 8)


def _price_pool(arch_cfg: ArchConfig, cluster: HeteroCluster, ci: int,
                role: str, layers: Sequence[Layer], scfg: ServingConfig,
                cost_cfg: CostModelConfig, cache: Dict,
                comm: Optional[CommModel]) -> Optional[PoolSpec]:
    """Price one sub-cluster as a serving pool, or None when the weights
    don't fit under the headroom (the pool is serving-infeasible)."""
    sub = cluster.subclusters[ci]
    weights = sum(l.param_bytes for l in layers)
    if weights > scfg.mem_headroom * sub.n_devices * sub.device.mem_bytes:
        return None
    bound = kvplan.decode_capacity(
        arch_cfg, sub, weights_bytes=weights,
        block_tokens=scfg.block_tokens, dtype_bytes=scfg.kv_dtype_bytes,
        mem_headroom=scfg.mem_headroom)
    mesh = Submesh(ci, sub.n_nodes, sub.devices_per_node)
    # the profiler's cost-cache key recipe (ZeroRedundantProfiler._cell_costs
    # base_key + tp=None): serving searches and training planner runs on the
    # same fleet share entries for matching (layers, mesh, chunk) cells
    key = (layer_class_sequence(layers, 0, len(layers)),
           sub.device, sub.node_efficiencies,
           sub.intra_node_bw, sub.inter_node_bw,
           mesh.n, mesh.m, scfg.prefill_chunk, cost_cfg, 0,
           None if comm is None else comm.sub_fingerprint(ci), None)
    cost = cache.get(key)
    if cost is None:
        cost = stage_cost(layers, sub, mesh, scfg.prefill_chunk, cost_cfg,
                          comm=comm)
        cache[key] = cost
    # decode roofline inputs: aggregate HBM and derated FLOPs, scaled by the
    # calibrated efficiency and the per-node mix (mean — decode DP shards
    # can be sized unevenly just like training's shard_ratios)
    scales = sub.node_scales()
    mean_scale = sum(scales) / len(scales)
    eff = sub.device.efficiency * mean_scale
    return PoolSpec(
        name=sub.name, cluster_idx=ci, role=role,
        n_devices=sub.n_devices,
        weights_bytes=weights,
        block_bytes=bound.block_bytes,
        blocks_capacity=bound.blocks_capacity,
        prefill_chunk_s=cost.t_f,
        hbm_bytes_per_s=sub.n_devices * sub.device.hbm_bw * eff,
        decode_flops_per_s=sub.n_devices * sub.device.peak_flops
        * sub.device.base_mfu * scfg.decode_mfu * eff)


def _handoff_tables(pools: Sequence[PoolSpec], comm: CommModel
                    ) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Per ordered pool pair: the physical link a KV handoff rides (the
    source's inter-node fabric inside a sub-cluster, the shared WAN across
    — ``comm.topology.p2p_link``) with its latency."""
    bw: Dict[str, float] = {}
    lat: Dict[str, float] = {}
    for i, src in enumerate(pools):
        for j, dst in enumerate(pools):
            if i == j:
                continue
            link = comm.topology.p2p_link(src.cluster_idx, dst.cluster_idx)
            key = f"{i}->{j}"
            bw[key] = link.bandwidth
            lat[key] = link.latency
    return bw, lat


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _assemble(arch_cfg: ArchConfig, roles: Sequence[str], priced: Dict,
              comm: CommModel, layers: Sequence[Layer],
              scfg: ServingConfig, routing: str) -> Optional[ServePlan]:
    pools = []
    for ci, role in enumerate(roles):
        if role == "off":
            continue
        spec = priced.get(ci)
        if spec is None:
            return None                 # weights don't fit on an used pool
        pools.append(dataclasses.replace(spec, role=role))
    if not any(p.can_prefill for p in pools) \
            or not any(p.can_decode for p in pools):
        return None
    # every decode pool must hold at least one worst-case sequence
    worst = scfg.prompt_mean + scfg.output_mean
    plan_blocks = None
    bw, lat = _handoff_tables(pools, comm)
    plan = ServePlan(
        arch=arch_cfg.arch_id, objective=scfg.objective, routing=routing,
        prefill_chunk=scfg.prefill_chunk, block_tokens=scfg.block_tokens,
        kv_bytes_per_token=kvplan.kv_bytes_per_token(
            arch_cfg, scfg.kv_dtype_bytes),
        state_bytes_per_seq=kvplan.state_bytes_per_seq(
            arch_cfg, scfg.kv_dtype_bytes),
        flops_per_token=sum(l.flops_per_token for l in layers),
        step_overhead_s=scfg.step_overhead_s, max_queue=scfg.max_queue,
        slo_ttft_s=scfg.slo_ttft_s, slo_tpot_s=scfg.slo_tpot_s,
        pools=pools, handoff_bw=bw, handoff_latency=lat)
    plan_blocks = plan.seq_blocks(worst)
    if any(p.can_decode and p.blocks_capacity < plan_blocks for p in pools):
        return None
    return plan


def colocated_plan(arch_cfg: ArchConfig, cluster: HeteroCluster,
                   scfg: Optional[ServingConfig] = None, *,
                   comm: Optional[CommModel] = None,
                   layers: Optional[Sequence[Layer]] = None,
                   cost_cache: Optional[Dict] = None) -> ServePlan:
    """The no-planning baseline: every feasible pool serves both phases
    (``mixed``) and prefill routing is *uniform* round-robin — blind to the
    pools' heterogeneous rates, exactly what a placement-unaware deployment
    does."""
    scfg = scfg or ServingConfig()
    comm = comm or CommModel(cluster)
    layers = list(layers) if layers is not None \
        else serving_layers(arch_cfg, scfg)
    cache = _COST_CACHE if cost_cache is None else cost_cache
    cost_cfg = CostModelConfig()
    priced = {ci: _price_pool(arch_cfg, cluster, ci, "mixed", layers, scfg,
                              cost_cfg, cache, comm)
              for ci in range(len(cluster.subclusters))}
    roles = ["mixed" if priced[ci] is not None else "off"
             for ci in range(len(cluster.subclusters))]
    plan = _assemble(arch_cfg, roles, priced, comm, layers, scfg,
                     routing="uniform")
    if plan is None:
        raise ValueError(
            f"no feasible colocated serving placement for "
            f"{arch_cfg.arch_id} on {cluster.describe()} (weights or one "
            f"worst-case sequence exceed every pool's memory)")
    return plan


def search_placement(arch_cfg: ArchConfig, cluster: HeteroCluster,
                     scfg: Optional[ServingConfig] = None, *,
                     trace: Optional[ServeTrace] = None,
                     comm: Optional[CommModel] = None,
                     layers: Optional[Sequence[Layer]] = None,
                     cost_cache: Optional[Dict] = None,
                     verbose: bool = False) -> ServePlan:
    """Enumerate role assignments, simulate each on a trace sample, keep the
    best under ``scfg.objective``.  The returned plan carries its predicted
    metrics and the colocated-uniform baseline's, both measured on the same
    sample (equal offered QPS)."""
    from repro_torch.serving.batching import simulate_trace

    scfg = scfg or ServingConfig()
    errs = scfg.validate_errors()
    if errs:
        raise ValueError("invalid ServingConfig: " + "; ".join(errs))
    comm = comm or CommModel(cluster)
    layers = list(layers) if layers is not None \
        else serving_layers(arch_cfg, scfg)
    cache = _COST_CACHE if cost_cache is None else cost_cache
    cost_cfg = CostModelConfig()
    if trace is None:
        trace = poisson_trace(scfg.qps, scfg.duration_s, seed=scfg.seed,
                              prompt_mean=scfg.prompt_mean,
                              output_mean=scfg.output_mean)
    sample = trace.take(scfg.search_sample)

    n_sub = len(cluster.subclusters)
    priced = {ci: _price_pool(arch_cfg, cluster, ci, "mixed", layers, scfg,
                              cost_cfg, cache, comm) for ci in range(n_sub)}

    best_plan: Optional[ServePlan] = None
    best_score = float("inf")
    n_cands = 0
    for roles in itertools.product(ROLES, repeat=n_sub):
        if all(r == "off" for r in roles):
            continue
        plan = _assemble(arch_cfg, roles, priced, comm, layers, scfg,
                         routing="least_loaded")
        if plan is None:
            continue
        n_cands += 1
        res = simulate_trace(plan, sample)
        s = score(res, scfg.objective, slo_ttft_s=scfg.slo_ttft_s,
                  slo_tpot_s=scfg.slo_tpot_s)
        if verbose:
            print(f"[serving] roles={roles} score={s:.4g} "
                  f"p99_ttft={res.p99_ttft_s * 1e3:.1f}ms "
                  f"rejected={res.n_rejected}")
        if better(s, best_score):
            best_score, best_plan = s, dataclasses.replace(
                plan, predicted=res.summary())
    if best_plan is None:
        raise ValueError(
            f"no feasible serving placement for {arch_cfg.arch_id} on "
            f"{cluster.describe()} ({n_sub} pools all infeasible)")
    base = colocated_plan(arch_cfg, cluster, scfg, comm=comm, layers=layers,
                          cost_cache=cache)
    base_res = simulate_trace(base, sample)
    best_plan.baseline = base_res.summary()
    if verbose:
        print(f"[serving] searched {n_cands} candidates; best score "
              f"{best_score:.4g}")
    return best_plan
