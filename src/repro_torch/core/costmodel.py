"""Analytic stage-on-submesh cost model (the CPU-only substitute for HAPT's
on-hardware profiler; structure documented in DESIGN.md §2).

For a candidate stage (contiguous layer range) on a submesh (n nodes x m
devices) of one sub-cluster, :func:`intra_op_candidates` enumerates the
canonical intra-operator factorizations — TP confined to a node with
Megatron-style all-reduces, DP across the rest — and prices each one as a
:class:`StageCost` carrying its :class:`~repro_torch.core.strategy.IntraOpPlan`:

- *tensor axis* (tp > 1): per-microbatch ring all-reduce of the row-parallel
  outputs over the sub-cluster's intra-node link, forward and backward;
- *data axis* (dp > 1): per-step gradient all-reduce over the dp link,
  amortized per microbatch when ``amortize_microbatches`` is set;
- *uneven shard ratios*: in a **mixed** sub-cluster
  (``SubCluster.node_efficiencies``) the data-parallel shards are sized
  proportionally to per-node efficiency (HAP-style), so every node finishes
  together; even sharding is instead bottlenecked by the slowest node.

:func:`stage_cost` keeps the legacy single-result contract (cheapest
candidate, even shards) for the inter-op-only path.  On real hardware,
``measure_fn`` replaces the analytic estimate per candidate without touching
the surrounding planner.

Units: seconds, bytes, bytes/s, FLOP/s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import HeteroCluster, SubCluster
from repro_torch.core.layering import Layer
from repro_torch.core.strategy import IntraOpPlan


@dataclass(frozen=True)
class Submesh:
    cluster_idx: int
    n: int
    m: int

    @property
    def n_devices(self) -> int:
        return self.n * self.m


@dataclass(frozen=True)
class StageCost:
    t_f: float            # forward per-microbatch (s), intra-op comm included
    t_b: float            # backward per-microbatch (s), intra-op comm included
    mem_p: float          # per-device param+optimizer bytes
    mem_a: float          # per-device activation bytes per in-flight microbatch
    tp: int
    dp: int
    dp_sync: float        # per-step gradient sync (amortized over microbatches)
    intra: Optional[IntraOpPlan] = None

    @property
    def t(self) -> float:
        return self.t_f + self.t_b


@dataclass(frozen=True)
class CostModelConfig:
    dtype_bytes: float = 2.0        # bf16 compute
    opt_mult: float = 7.0           # (bf16 p) + f32 master + adam m,v = 14B/param
    zero1: bool = True              # shard optimizer states over dp
    remat: bool = True              # store only layer-boundary activations
    bwd_flops_mult: float = 2.0
    tp_eff_decay: float = 0.95      # MFU multiplier per 2x TP
    dp_eff_decay: float = 0.99


def _mfu(sub: SubCluster, tp: int, dp: int, cfgm: CostModelConfig,
         kbench=None) -> float:
    # device.efficiency is the runtime-calibration scale (telemetry EWMA);
    # a straggling sub-cluster shows up here and shifts the whole plan
    eff = sub.device.base_mfu * sub.device.efficiency
    if kbench is not None:
        # measured-kernel anchor (repro_torch.kbench): a latency table covering
        # this device replaces the spec-sheet base_mfu with the achieved
        # MFU; uncovered devices keep the analytic anchor untouched
        measured = kbench.measured_mfu(sub)
        if measured is not None:
            eff = measured * sub.device.efficiency
    eff *= cfgm.tp_eff_decay ** max(0, math.log2(max(tp, 1)))
    eff *= cfgm.dp_eff_decay ** max(0, math.log2(max(dp, 1)))
    return eff


def _shard_ratios(scales: Sequence[float], per_node: int,
                  uneven: bool) -> Tuple[float, ...]:
    """Per-dp-shard microbatch fractions: each node contributes ``per_node``
    shards at its efficiency scale.  Uneven -> proportional to scale (sums
    to 1); even -> uniform."""
    shard_scales = [s for s in scales for _ in range(per_node)]
    dp = len(shard_scales)
    if not uneven or dp == 0:
        return (1.0 / max(dp, 1),) * max(dp, 1)
    total = sum(shard_scales)
    return tuple(s / total for s in shard_scales)


def intra_op_candidates(layers: Sequence[Layer], sub: SubCluster,
                        mesh: Submesh, mb_tokens: int,
                        cfgm: CostModelConfig = CostModelConfig(), *,
                        uneven: bool = True,
                        amortize_microbatches: int = 0,
                        max_degree: int = 0,
                        comm=None, kbench=None) -> List[StageCost]:
    """All candidate intra-op shardings of this stage on this submesh, one
    per tensor-parallel width tp (powers of two dividing ``mesh.m``, capped
    by ``max_degree`` when > 0).  Each result carries its IntraOpPlan; the
    joint DP chooses among them per (stage-slice, t_max) instead of greedily
    taking the cheapest.

    ``comm`` (optional :class:`repro_torch.comm.selector.CommModel`): price the TP
    all-reduce and DP gradient sync under the *selected* collective
    algorithm (ring / recursive halving-doubling / two-level hierarchical,
    whichever is cheapest on this submesh's link tiers) instead of the
    implicit flat ring; the chosen algorithm names ride on the
    ``IntraOpPlan``.  ``comm=None`` is the legacy scalar pricing,
    bit-identical to before the comm subsystem existed.

    ``kbench`` (optional :class:`repro_torch.kbench.bridge.KBenchModel`): anchor
    the compute MFU at the device's *measured* kernel throughput instead of
    the spec-sheet ``base_mfu`` (see :func:`_mfu`).  ``kbench=None`` — and a
    model whose table doesn't cover this device — leaves the analytic
    pricing bit-identical."""
    flops = sum(l.flops_per_token for l in layers) * mb_tokens
    params = sum(l.param_bytes for l in layers)
    ar_bytes = sum(l.ar_bytes_per_token for l in layers) * mb_tokens
    act_bytes = sum(l.act_out_bytes_per_token for l in layers) * mb_tokens
    n, m = mesh.n, mesh.m
    dev = sub.device
    scales = sub.node_scales(n)

    out: List[StageCost] = []
    tp = 1
    while tp <= m:
        if m % tp == 0 and not (max_degree and tp > max_degree):
            per_node = m // tp
            dp = n * per_node
            ratios = _shard_ratios(scales, per_node, uneven)
            # uneven, efficiency-proportional shards let every node finish
            # together (throughput = mean node scale); even shards wait for
            # the slowest node (throughput = min node scale)
            scale = (sum(scales) / len(scales)) if uneven else min(scales)
            eff = _mfu(sub, tp, dp, cfgm, kbench) * scale
            t_comp_f = flops / (mesh.n_devices * dev.peak_flops * eff)
            # Megatron TP: all-reduce row-parallel outputs over NVLink/ICI.
            # ring all-reduce moves 2(tp-1)/tp of payload; fwd once, bwd once.
            # The stage's critical path is the *largest* data shard's group,
            # whose AR payload is max(ratios)*ar_bytes (= ar_bytes/dp even).
            ar_algo = sync_algo = None
            sync_compressed = False
            if tp > 1:
                ar_shard = ar_bytes * max(ratios)
                if comm is not None:
                    sel_ar = comm.tp_allreduce(mesh.cluster_idx, tp, ar_shard)
                    t_ar, ar_algo = sel_ar.seconds, sel_ar.algorithm
                else:
                    t_ar = ar_shard * 2 * (tp - 1) / tp / sub.intra_node_bw
                ar_payload = 2 * ar_shard * 2 * (tp - 1) / tp
            else:
                t_ar = 0.0
                ar_payload = 0.0
            # per-step dp grad sync; amortized per microbatch when the joint
            # search prices the data axis (B = amortize_microbatches).  With a
            # comm model the sync runs the cheapest selected algorithm over
            # the stage's (intra-node, inter-node) link tiers — two-level
            # hierarchical typically beats the flat ring once n > 1.
            if dp > 1:
                if comm is not None:
                    sel_s = comm.dp_sync(mesh.cluster_idx, n, per_node, params)
                    dp_sync, sync_algo = sel_s.seconds, sel_s.algorithm
                    sync_compressed = sel_s.compressed
                else:
                    bw = sub.inter_node_bw if n > 1 else sub.intra_node_bw
                    dp_sync = params * 2 * (dp - 1) / dp / bw
            else:
                dp_sync = 0.0
            sync_mb = dp_sync / amortize_microbatches \
                if amortize_microbatches else 0.0
            sync_payload = (params * 2 * (dp - 1) / dp / amortize_microbatches
                            if amortize_microbatches and dp > 1 else 0.0)
            t_f = t_comp_f + t_ar
            t_b = cfgm.bwd_flops_mult * t_comp_f + t_ar + sync_mb
            # memory: weights/optimizer shard evenly; the activation bound is
            # set by the *largest* data shard (the fastest node's devices)
            shard = tp * (dp if cfgm.zero1 else 1)
            mem_p = params * (1.0 + cfgm.opt_mult) / min(shard, mesh.n_devices)
            act_stored = act_bytes if cfgm.remat else 3.0 * act_bytes
            mem_a = act_stored * max(ratios) / tp
            plan = IntraOpPlan(
                axis="tensor" if tp > 1 else "data", tp=tp, dp=dp,
                shard_ratios=ratios, comm_bytes=ar_payload + sync_payload,
                comm_time_f=t_ar, comm_time_b=t_ar + sync_mb,
                sync_time=sync_mb, ar_algo=ar_algo, sync_algo=sync_algo,
                sync_compressed=sync_compressed)
            out.append(StageCost(t_f, t_b, mem_p, mem_a, tp, dp, dp_sync,
                                 intra=plan))
        tp *= 2
    return out


def stage_cost(layers: Sequence[Layer], sub: SubCluster, mesh: Submesh,
               mb_tokens: int, cfgm: CostModelConfig = CostModelConfig(),
               measure_fn: Optional[Callable] = None,
               comm=None, kbench=None) -> StageCost:
    """Cheapest feasible intra-op strategy for this stage-mesh pair — the
    inter-op-only (greedy) contract: even shards, fastest ``t = t_f + t_b``.
    The joint search uses :func:`intra_op_candidates` instead."""
    if measure_fn is not None:
        return measure_fn(layers, sub, mesh, mb_tokens)
    cands = intra_op_candidates(layers, sub, mesh, mb_tokens, cfgm,
                                uneven=False, comm=comm, kbench=kbench)
    assert cands, "no intra-op factorization for mesh"
    return min(cands, key=lambda c: c.t)


def cut_comm_bytes(layers: Sequence[Layer], cut_after: int, mb_tokens: int) -> float:
    """Bytes of the activation crossing the stage boundary after layer index
    ``cut_after`` (exclusive end of the left stage), per microbatch."""
    if cut_after <= 0 or cut_after >= len(layers):
        return 0.0
    return layers[cut_after - 1].act_out_bytes_per_token * mb_tokens


def memory_feasible(cost: StageCost, sub: SubCluster, warmup_k: int) -> bool:
    """Eq. 18: mem_p + K * mem_a <= mem_device."""
    return cost.mem_p + warmup_k * cost.mem_a <= sub.device.mem_bytes
