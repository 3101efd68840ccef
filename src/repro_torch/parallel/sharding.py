"""Host part of the reference's ``repro/parallel/sharding.py``: the
logical-axis partition rules for parameters and training activations, and
the lowering of a planner :class:`~repro_torch.core.strategy.IntraOpPlan`
to logical mesh axes and integer shard sizes, which ``api.lower`` and
``repro_torch.migrate`` read.

Parameter specs are derived from leaf *names* in the model's parameter
tree (every model family uses the same naming vocabulary), with
trailing-dims matching: a rule gives the spec of the rightmost dims; any
extra leading dims (layer stacks, pipeline-stage dims) are padded with
``None`` / the stage axis.  A spec is a tuple of mesh-axis names and
``None``, one entry per dim (the reference's ``PartitionSpec`` as a
tuple); the rules are host data and name no device.  Axes: ``data`` (DP +
FSDP), ``model`` (TP/SP), ``pod`` (pipeline, multi-pod only).

One pipeline stage's plan becomes a ``(data=dp, model=tp)`` layout over the
stage's devices, and the plan's shard ratios become integer per-shard batch
sizes (largest-remainder apportionment — sizes always sum to the batch).
Invariants: ``shard_ratios`` sum to 1 (validated here, units dimensionless);
the degenerate ``degree == 1`` plan lowers to a 1x1 layout, i.e. a no-op.
Not here: device meshes (``mesh_from_intra_op``), placements of tensors on
them, and the prefill / decode / cache rules that go with them (ROADMAP.md,
Queue 1 item 5).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.strategy import IntraOpPlan

Spec = Tuple[Optional[str], ...]

FSDP = "data"
TP = "model"

# rule: leaf name -> trailing-dim partition entries
_PARAM_RULES: Dict[str, Tuple] = {
    # embeddings / head
    "embed": (TP, FSDP),           # (V, d)
    "lm_head": (FSDP, TP),         # (d, V)
    "pos_embed": (None, FSDP),
    # attention / mlp / adapters (column-parallel in, row-parallel out)
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
    "wo": (TP, FSDP),
    "w_up": (FSDP, TP), "w_gate": (FSDP, TP), "w_down": (TP, FSDP),
    "adapt_in": (FSDP, TP), "adapt_out": (TP, FSDP),
    # MoE (expert dim -> FSDP axis = expert parallelism inside the pod)
    "router": (FSDP, None),
    "moe:w_up": (FSDP, None, TP), "moe:w_gate": (FSDP, None, TP),
    "moe:w_down": (FSDP, TP, None),
    # SSM
    "in_proj": (FSDP, TP),
    "conv_w": (None, TP), "conv_b": (TP,),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
    "norm_w": (TP,), "out_proj": (TP, FSDP),
    # norms / scalars
    "ln": (None,), "ln1": (None,), "ln2": (None,), "ln_x": (None,),
    "final_norm": (None,), "enc_norm": (None,),
    "gate_a": (), "gate_m": (),
}


def _leaf_spec(path: Tuple[str, ...], ndim: int) -> Spec:
    name = path[-1]
    in_moe = "moe" in path
    rule = None
    if in_moe and f"moe:{name}" in _PARAM_RULES:
        rule = _PARAM_RULES[f"moe:{name}"]
    elif name in _PARAM_RULES:
        rule = _PARAM_RULES[name]
    if rule is None:
        raise KeyError(f"no sharding rule for param {'/'.join(path)}")
    pad = ndim - len(rule)
    assert pad >= 0, f"{path}: rule {rule} longer than ndim {ndim}"
    return (*([None] * pad), *rule)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_pspecs(params_tree) -> Any:
    """Spec tree matching ``params_tree`` (anything with ``.shape``:
    tensors, ``meta`` tensors, numpy arrays)."""
    return _map_with_path(lambda path, leaf: _leaf_spec(path, len(leaf.shape)),
                          params_tree)


def staged_param_pspecs(params_tree, stage_axis: str = "pod") -> Any:
    """Specs for pipeline-staged params: leading stage dim on every leaf."""
    return _map_with_path(
        lambda path, leaf: (stage_axis, *_leaf_spec(path, len(leaf.shape) - 1)),
        params_tree)


def train_act_rules() -> Dict[str, Optional[object]]:
    """Training activations: DP over data, TP over model, single-pod and
    inside a pipeline stage alike (the pod axis is the pipeline's, outside
    the stage body), so the reference's ``multi_pod`` flag changes
    nothing and is not kept."""
    return {
        "batch": "data", "batch_head": "data", "seq": None, "embed": None,
        "heads": "model", "kv_heads": "model", "ff": "model",
        "vocab": "model", "expert": "data", "kv_seq": None,
    }


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
    slice (ROADMAP.md, Queue 1 item 5), which the partition rules above
    will place tensors on."""
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
