"""Parallel strategy IR: what the planner emits and the runtime consumes.

Three layers, all plain dataclasses with a lossless JSON round trip
(``ParallelStrategy.to_json`` / ``from_json`` — the elastic runtime's plan
cache and any external tooling depend on it):

- :class:`IntraOpPlan` — the *intra-operator* half of the two-level search:
  how one pipeline stage is sharded inside its submesh (tensor vs. data
  axis, degrees, uneven shard ratios, priced collective traffic).
- :class:`StageAssignment` — one pipeline stage: a contiguous layer range
  placed on a submesh of one sub-cluster, with per-microbatch costs and the
  chosen intra-op plan.
- :class:`ParallelStrategy` — the full plan: stage list, inter-stage comm
  times, H-1F1B warm-up counts, and planner provenance.

Units everywhere: times in seconds, memory/traffic in bytes, bandwidth in
bytes/s, flops in FLOP/s.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class IntraOpPlan:
    """How one stage is sharded *inside* its submesh (HAP/Poplar-style
    heterogeneity-aware intra-operator parallelism).

    Invariants:

    - ``tp * dp == StageAssignment.n_devices`` of the owning stage;
    - ``len(shard_ratios) == dp`` and ``sum(shard_ratios) == 1`` (each entry
      is the fraction of the microbatch processed by one data-parallel
      shard; uneven entries are proportional to per-node efficiency in a
      mixed sub-cluster, all equal to ``1/dp`` in a homogeneous one);
    - ``shard_ratios`` are ordered **slowest node first** (the
      ``SubCluster.node_scales`` order, ascending efficiency) — whoever
      materializes the plan must hand ``mesh_from_intra_op`` the stage's
      devices in that same node order, or the largest shard lands on the
      wrong (possibly slowest) node and the priced throughput is forfeited;
    - ``degree == 1`` (tp == dp == 1) is the degenerate no-op plan.
    """
    axis: str                          # "tensor" (Megatron TP) | "data" (DP)
    tp: int                            # tensor-parallel width (within a node)
    dp: int                            # data-parallel width (across the rest)
    shard_ratios: Tuple[float, ...]    # per-dp-shard microbatch fraction, sums to 1
    comm_bytes: float                  # per-microbatch collective payload (bytes)
    comm_time_f: float                 # forward intra-op collective time (s)
    comm_time_b: float                 # backward intra-op collective time (s)
    sync_time: float = 0.0             # share of comm_time_b that is amortized
                                       # per-step gradient sync (s); 0 when the
                                       # search did not price the data axis
    ar_algo: Optional[str] = None      # collective algorithm selected for the
                                       # TP all-reduce (repro_torch.comm.selector);
                                       # None = legacy implicit flat ring
    sync_algo: Optional[str] = None    # ditto for the DP gradient sync
    sync_compressed: bool = False      # sync priced with int8 block
                                       # quantization (error-feedback path)

    @property
    def degree(self) -> int:
        """Sharding degree along the dominant ``axis``."""
        return self.tp if self.axis == "tensor" else self.dp

    @property
    def n_devices(self) -> int:
        return self.tp * self.dp

    @property
    def comm_time(self) -> float:
        """Total per-microbatch intra-op collective time (s)."""
        return self.comm_time_f + self.comm_time_b

    @property
    def is_uneven(self) -> bool:
        """True when the data-parallel shards are heterogeneity-weighted."""
        if not self.shard_ratios:
            return False
        return max(self.shard_ratios) - min(self.shard_ratios) > 1e-12


@dataclass(frozen=True)
class StageAssignment:
    """One pipeline stage: layers ``[layer_start, layer_end)`` on a
    ``mesh_n x mesh_m`` submesh of sub-cluster ``cluster_idx``.

    ``t_f``/``t_b`` are per-microbatch forward/backward seconds (intra-op
    collective time included); ``mem_p``/``mem_a`` are per-device bytes for
    parameters+optimizer and per-in-flight-microbatch activations (the Eq. 18
    operands).  ``tp``/``dp`` duplicate the chosen intra-op factorization for
    quick access; ``intra_op`` (when the joint search ran) carries the full
    :class:`IntraOpPlan` that `parallel.sharding.mesh_from_intra_op` lowers
    to an executable mesh.
    """
    layer_start: int
    layer_end: int                 # exclusive
    cluster_idx: int
    mesh_n: int
    mesh_m: int
    tp: int
    dp: int
    t_f: float
    t_b: float
    mem_p: float
    mem_a: float
    intra_op: Optional[IntraOpPlan] = None

    @property
    def n_devices(self) -> int:
        return self.mesh_n * self.mesh_m

    @property
    def t(self) -> float:
        """Per-microbatch compute time f+b (s)."""
        return self.t_f + self.t_b


@dataclass
class ParallelStrategy:
    """The planner's output and the runtime's input.

    Invariants: ``stages`` tile the layer range contiguously;
    ``len(c_links) == n_stages - 1`` (per-microbatch inter-stage activation
    transfer seconds); ``len(warmup_counts) == n_stages`` (H-1F1B ``N_i``,
    non-increasing, last entry 1); every stage satisfies ``t <= t_max`` and
    every link ``c <= t_max``.
    """
    stages: List[StageAssignment]
    c_links: List[float]           # inter-stage comm time per microbatch (s)
    warmup_counts: List[int]       # H-1F1B N_i
    t_max: float                   # the pipeline's bottleneck period (s)
    n_microbatches: int
    mb_tokens: int                 # tokens per microbatch
    est_step_time: float = 0.0     # from pipesim (s)
    eta: float = 1.0               # Eq. 19 load balance in [0, 1]
    planner_meta: Dict = field(default_factory=dict)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def devices_used(self) -> int:
        return sum(s.n_devices for s in self.stages)

    def tokens_per_step(self) -> int:
        return self.mb_tokens * self.n_microbatches

    def throughput_tokens_per_s(self) -> float:
        return self.tokens_per_step() / self.est_step_time if self.est_step_time else 0.0

    # -- (de)serialization ---------------------------------------------------
    def to_json(self) -> str:
        """Lossless JSON (see docs/planner.md for the schema field-by-field)."""
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "ParallelStrategy":
        d = json.loads(s)
        stages = []
        for st in d["stages"]:
            io = st.pop("intra_op", None)
            if io is not None:
                io["shard_ratios"] = tuple(io["shard_ratios"])
                io = IntraOpPlan(**io)
            stages.append(StageAssignment(intra_op=io, **st))
        d["stages"] = stages
        return ParallelStrategy(**d)

    def describe(self) -> str:
        lines = [f"{self.n_stages} stages, B={self.n_microbatches} microbatches,"
                 f" t_max={self.t_max*1e3:.2f} ms, est step {self.est_step_time*1e3:.1f} ms,"
                 f" eta={self.eta*100:.1f}%"]
        for i, s in enumerate(self.stages):
            c = self.c_links[i] if i < len(self.c_links) else 0.0
            intra = ""
            if s.intra_op is not None and s.intra_op.is_uneven:
                r = "/".join(f"{x:.2f}" for x in s.intra_op.shard_ratios)
                intra = f" shards[{r}]"
            if s.intra_op is not None and s.intra_op.sync_algo:
                intra += f" sync={s.intra_op.sync_algo}"
                if s.intra_op.sync_compressed:
                    intra += "+int8"
            lines.append(
                f"  stage{i}: layers[{s.layer_start}:{s.layer_end}] "
                f"cluster{s.cluster_idx} mesh({s.mesh_n}x{s.mesh_m}) tp={s.tp} dp={s.dp}"
                f"{intra} t={s.t*1e3:.2f}ms N={self.warmup_counts[i]} c->next={c*1e3:.2f}ms")
        return "\n".join(lines)
