"""Host part of the reference's ``repro/parallel/sharding.py``: the lowering
of a planner :class:`~repro_torch.core.strategy.IntraOpPlan` to logical mesh
axes and integer shard sizes, which ``api.lower`` and ``repro_torch.migrate``
read.

One pipeline stage's plan becomes a ``(data=dp, model=tp)`` layout over the
stage's devices, and the plan's shard ratios become integer per-shard batch
sizes (largest-remainder apportionment — sizes always sum to the batch).
Invariants: ``shard_ratios`` sum to 1 (validated here, units dimensionless);
the degenerate ``degree == 1`` plan lowers to a 1x1 layout, i.e. a no-op.
Not here: the parameter / cache partition rules and ``mesh_from_intra_op``,
which build device meshes (ROADMAP.md, Queue 1 item 5).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.strategy import IntraOpPlan


def validate_intra_op_plan(plan: IntraOpPlan) -> None:
    """Check the planner's invariants before lowering: ratios are positive,
    one per data-parallel shard, and sum to 1; degrees are positive."""
    if plan.tp < 1 or plan.dp < 1:
        raise ValueError(f"degrees must be >= 1, got tp={plan.tp} dp={plan.dp}")
    if len(plan.shard_ratios) != plan.dp:
        raise ValueError(
            f"{len(plan.shard_ratios)} shard ratios for dp={plan.dp}")
    if any(r <= 0 for r in plan.shard_ratios):
        raise ValueError(f"non-positive shard ratio in {plan.shard_ratios}")
    total = sum(plan.shard_ratios)
    if abs(total - 1.0) > 1e-6:
        raise ValueError(f"shard ratios sum to {total}, expected 1")


def intra_op_mesh_axes(plan: IntraOpPlan) -> Tuple[Tuple[str, int], ...]:
    """Logical mesh layout for one stage: ``(("data", dp), ("model", tp))``.
    Pure (no devices needed); the mesh itself is built by the device-mesh
    slice (ROADMAP.md, Queue 1 item 5)."""
    validate_intra_op_plan(plan)
    return (("data", plan.dp), ("model", plan.tp))


def hierarchical_sync_axes(plan: IntraOpPlan, mesh_n: int
                           ) -> Tuple[Tuple[str, int], ...]:
    """Mesh layout that lowers the *two-level hierarchical* gradient sync
    (``plan.sync_algo == "hierarchical"``) of a stage spanning ``mesh_n``
    nodes: the flat ``("data", dp)`` axis splits into ``("node", mesh_n)``
    x ``("data", dp // mesh_n)`` so the reduce's phases map onto named
    axes — reduce-scatter over ``data`` (intra-node fabric), cross-node
    allreduce over ``node`` (inter-node fabric), allgather over ``data``.
    Requires ``mesh_n`` to divide ``dp`` (it does by construction:
    ``dp = mesh_n * per_node``)."""
    validate_intra_op_plan(plan)
    if mesh_n < 1 or plan.dp % mesh_n != 0:
        raise ValueError(
            f"mesh_n={mesh_n} does not factor dp={plan.dp}")
    return (("node", mesh_n), ("data", plan.dp // mesh_n),
            ("model", plan.tp))


def sync_collective_phases(plan: IntraOpPlan, mesh_n: int
                           ) -> Tuple[Tuple[str, str], ...]:
    """The gradient sync as (collective, mesh axis) phases, matching the
    algorithm the planner priced (``repro_torch.comm.algorithms``):

    - hierarchical (multi-node stage): reduce-scatter over ``data``,
      allreduce over ``node``, allgather over ``data``;
    - anything else (flat ring / rhd / legacy): one allreduce over the flat
      data axis.

    Executors iterate these phases verbatim; the axis names refer to
    :func:`hierarchical_sync_axes` / :func:`intra_op_mesh_axes`."""
    if plan.sync_algo == "hierarchical" and mesh_n > 1:
        return (("reduce_scatter", "data"), ("all_reduce", "node"),
                ("all_gather", "data"))
    return (("all_reduce", "data"),)


def apportion(total: int, weights: Sequence[float]) -> List[int]:
    """Largest-remainder apportionment of ``total`` integer units across
    ``weights`` (need not be normalized).  Always sums to ``total`` exactly
    — the shared primitive behind :func:`batch_shard_sizes` (samples) and
    ``repro_torch.migrate``'s byte-interval layouts, where exactness is what makes
    plan-to-plan resharding bit-identical."""
    if total < 0:
        raise ValueError("total must be non-negative")
    if not weights or any(w < 0 for w in weights):
        raise ValueError(f"weights must be non-empty and >= 0: {weights}")
    wsum = float(sum(weights))
    if wsum <= 0:
        raise ValueError("weights must sum to > 0")
    quotas = [w / wsum * total for w in weights]
    sizes = [int(q) for q in quotas]
    rema = sorted(range(len(weights)), key=lambda i: quotas[i] - sizes[i],
                  reverse=True)
    for i in rema[: total - sum(sizes)]:
        sizes[i] += 1
    return sizes


def batch_shard_sizes(plan: IntraOpPlan, batch: int) -> List[int]:
    """Integer per-dp-shard batch sizes from the plan's (possibly uneven)
    ratios, by largest-remainder apportionment.  Always sums to ``batch``;
    even ratios reproduce the usual ``batch // dp`` split.  ``batch`` is a
    sample/microbatch count, not bytes."""
    validate_intra_op_plan(plan)
    return apportion(batch, list(plan.shard_ratios))
