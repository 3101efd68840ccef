"""Logical-axis sharding rules -> partition specs for parameters, optimizer
states, activations and KV caches — and the lowering of a planner
:class:`~repro_torch.core.strategy.IntraOpPlan` to a ``torch.distributed``
:class:`~torch.distributed.device_mesh.DeviceMesh`.

Counterpart of the reference's ``repro/parallel/sharding.py``.  Parameter
specs are derived from leaf *names* in the model's parameter tree (every
model family uses the same naming vocabulary), with trailing-dims matching:
a rule gives the spec of the rightmost dims; any extra leading dims (layer
stacks, pipeline-stage dims) are padded with ``None`` / the stage axis.  A
spec is a tuple of mesh-axis names, tuples of them and ``None``, one entry
per dim (the reference's ``PartitionSpec`` as a tuple); the rules are host
data and name no device.  Axes: ``data`` (DP + FSDP), ``model`` (TP/SP),
``pod`` (pipeline, multi-pod only).

On a mesh, a spec becomes a :class:`NamedSharding`: DTensor placements, one
per mesh dim (``Shard(d)`` on the mesh dims that ``spec[d]`` names,
``Replicate()`` elsewhere).  As in JAX, a dim that its mesh axes do not
divide is refused, never split unevenly; :func:`fit_spec` replicates such
dims first, as the reference's launcher does.

One pipeline stage's plan becomes a ``(data=dp, model=tp)`` mesh over the
stage's ranks (:func:`mesh_from_intra_op`), and the plan's shard ratios
become integer per-shard batch sizes (largest-remainder apportionment —
sizes always sum to the batch).  Invariants: ``shard_ratios`` sum to 1
(validated here, units dimensionless); the degenerate ``degree == 1`` plan
lowers to a 1x1 mesh, i.e. a no-op.  The act rules here are the
reference's; ``models.common.shard_act`` places activations by them on
DTensors, and :meth:`NamedSharding.place` builds a DTensor of a ``meta`` or
fake leaf from its shard shape alone (the launcher's dry run).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.strategy import IntraOpPlan
from repro_torch.train.optimizer import tree_map

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

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


def prefill_act_rules(multi_pod: bool = False) -> Dict[str, Optional[object]]:
    """Prefill is pure forward: DP over every free axis (pods included); the
    produced KV cache is sequence-sharded over model (decode layout)."""
    return {
        "batch": ("pod", "data") if multi_pod else "data",
        "batch_head": ("pod", "data") if multi_pod else "data",
        "seq": None, "embed": None,
        "heads": "model", "kv_heads": None, "ff": "model",
        "vocab": "model", "expert": "data", "kv_seq": "model",
    }


def decode_act_rules(batch: int, multi_pod: bool = False) -> Dict[str, Optional[object]]:
    """Decode: batch over (pod?, data) + KV-cache *sequence* over model (the
    distributed-decode layout — works for any kv-head count incl. MQA);
    batch=1 long-context shards the cache sequence over every free axis."""
    if batch >= 16:
        return {
            "batch": ("pod", "data") if multi_pod else "data",
            "seq": None, "embed": None,
            "heads": "model", "kv_heads": None, "ff": "model",
            "vocab": "model", "expert": "data",
            "kv_seq": "model",
        }
    # long-context: sequence-shard the cache
    kv = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "batch": None, "batch_head": None, "seq": None, "embed": None,
        "heads": "model", "kv_heads": None, "ff": "model",
        "vocab": "model", "expert": "data",
        "kv_seq": kv,  # kv_heads must stay None: same spec as kv_seq axes
    }


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``) or of any mesh with ``axis_names`` and a ``devices`` array
    (the reference's meshes and its tests' stand-ins)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fit_spec(mesh, spec: Spec, shape) -> Spec:
    """Drop partition entries whose mesh-axis product does not divide the
    corresponding dim (e.g. vocab 50280 over 16-way 'model', kv_heads 8 over
    16) — those dims are replicated instead.  Placements require exact
    divisibility (:meth:`NamedSharding.shard_shape`); real deployments pad
    instead."""
    ax_size = mesh_axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        kept: List[str] = []
        for a in _entry_axes(entry):
            prod = 1
            for kk in kept + [a]:
                prod *= ax_size[kk]
            if shape[i] % prod == 0:
                kept.append(a)
        out.append(tuple(kept) if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``: the reference's
    ``jax.sharding.NamedSharding``.

    :meth:`placements` gives DTensor's placements, one per mesh dim: the
    mesh dims that ``spec[d]`` names shard tensor dim ``d``
    (``Shard(d)``), every other mesh dim replicates.  An entry naming
    several mesh dims, such as ``("pod", "data")``, shards its tensor dim
    major to minor, which DTensor does only when they are in the mesh's
    order: any other order raises.  :meth:`shard_shape` (and so
    :meth:`distribute`) refuses a dim its axes do not divide, where DTensor
    would split it unevenly; pass the spec through :func:`fit_spec` first
    (:func:`fitted_shardings` does)."""
    mesh: Any
    spec: Spec

    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out: List[Any] = [Replicate()] * len(names)
        used: set = set()
        for d, entry in enumerate(self.spec):
            idx = []
            for a in _entry_axes(entry):
                if a not in names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, not "
                                     f"one of the mesh's {tuple(names)}")
                if a in used:
                    raise ValueError(f"spec {self.spec} uses axis {a!r} twice")
                used.add(a)
                idx.append(names.index(a))
            if idx != sorted(idx):
                raise ValueError(
                    f"spec entry {entry} is not in the mesh's axis order "
                    f"{tuple(names)}; DTensor shards a dim major to minor only "
                    f"in mesh order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The local shape of a tensor of global ``shape`` on each rank."""
        sizes = mesh_axis_sizes(self.mesh)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than shape {tuple(shape)}")
        out = list(shape)
        for d, entry in enumerate(self.spec):
            n = 1
            for a in _entry_axes(entry):
                if a not in sizes:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, not "
                                     f"one of the mesh's {tuple(sizes)}")
                n *= sizes[a]
            if out[d] % n:
                raise ValueError(
                    f"dim {d} of shape {tuple(shape)} does not divide into "
                    f"{n} shards over {entry!r}; fit_spec replicates it")
            out[d] //= n
        return tuple(out)

    def distribute(self, tensor, device=None):
        """``tensor`` (the whole of it, the same on every rank, on any
        device: the host's, say, as each rank restores it from one
        checkpoint) as a DTensor whose local tensor is this rank's shard,
        cut where ``tensor`` lies and copied to ``device`` (default: the
        mesh's device type; a ``meta`` tensor stays meta).  The whole
        tensor never reaches ``device``, no data moves between ranks, and
        the shard shares no storage with ``tensor``."""
        import torch
        from torch.distributed.tensor import DTensor, Shard

        shape = tuple(tensor.shape)
        local_shape = self.shard_shape(shape)
        placements = self.placements()
        coord = self.mesh.get_coordinate()
        if device is None:
            device = "meta" if tensor.is_meta else self.mesh.device_type
        part = tensor.detach()
        for d in range(len(shape)):
            idx = 0                      # major to minor, as DTensor shards
            for i, p in enumerate(placements):
                if isinstance(p, Shard) and p.dim == d:
                    idx = idx * self.mesh.size(i) + coord[i]
            part = part.narrow(d, idx * local_shape[d], local_shape[d])
        local = torch.empty(local_shape, dtype=tensor.dtype, device=device)
        if not local.is_meta:
            local.copy_(part)
        out = DTensor.from_local(local, self.mesh, placements, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=_contiguous_stride(shape))
        return out.requires_grad_(tensor.requires_grad)

    def place(self, struct, device=None):
        """A DTensor of ``struct``'s global shape and dtype (``struct`` is
        anything with ``.shape`` and ``.dtype``: a ``meta`` tensor, a fake
        one) whose local shard is ``torch.empty`` of :meth:`shard_shape` on
        ``device`` (default ``struct.device``).  Under the caller's
        ``FakeTensorMode`` the shard is fake: no global tensor is built
        and nothing is allocated.  The contents are undefined."""
        import torch
        from torch.distributed.tensor import DTensor

        shape = tuple(struct.shape)
        local = torch.empty(self.shard_shape(shape), dtype=struct.dtype,
                            device=struct.device if device is None else device)
        return DTensor.from_local(local, self.mesh, self.placements(),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def fitted_shardings(mesh, spec_tree, struct_tree) -> Any:
    """:class:`NamedSharding` tree with per-leaf divisibility fitting;
    ``struct_tree`` holds anything with ``.shape``."""
    return tree_map(lambda sp, st: NamedSharding(mesh, fit_spec(mesh, sp, st.shape)),
                    spec_tree, struct_tree)


def batch_shardings(mesh, batch_tree, batch_axis) -> Any:
    """``Shard(0)`` over ``batch_axis`` (a mesh dim name or a tuple of
    them) for every leaf of a batch, replicated elsewhere: the reference
    launcher's ``P(batch_axis, None, ...)``, fitted (a batch smaller than
    the axes, one microbatch of a multi-pod cell, say, is replicated over
    the axes that do not divide it)."""
    return tree_map(lambda x: NamedSharding(mesh, fit_spec(
        mesh, (batch_axis, *([None] * (len(x.shape) - 1))), x.shape)), batch_tree)


def param_shardings(params_tree, mesh) -> Any:
    """:class:`NamedSharding` tree of the param rules (not fitted, as the
    reference's)."""
    return tree_map(lambda spec: NamedSharding(mesh, spec), param_pspecs(params_tree))


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
    Pure (no devices needed) — :func:`mesh_from_intra_op` materializes
    it."""
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


def mesh_from_intra_op(plan: IntraOpPlan, devices: Optional[Sequence[int]] = None,
                       *, hierarchy_nodes: Optional[int] = None,
                       device_type: str = "cuda"):
    """Materialize a stage's ``IntraOpPlan`` as a ``DeviceMesh`` with dims
    ``("data", "model")`` of shape ``(dp, tp)``.  ``devices`` are global
    ranks of the initialised ``torch.distributed`` group (one rank per
    device), default ``range(world_size)``, and must supply at least
    ``plan.n_devices`` entries; the degenerate degree=1 plan yields a 1x1
    mesh (single-device no-op through which every spec replicates).  The
    caller initialises the process group; without one this raises rather
    than start one.

    CONTRACT on ranks: unlike the reference's ``Mesh``, a local object that
    any process can build for any stage, building a ``DeviceMesh`` is
    collective over the whole process group (it creates the mesh's
    subgroups).  Every rank of the group calls this for every stage's mesh,
    its own and the others', in the same order; a rank outside ``devices``
    gets a mesh whose ``get_coordinate()`` is ``None``.  Called only on the
    ranks of one stage, it hangs or pairs the wrong subgroups.

    CONTRACT for uneven plans: ``plan.shard_ratios`` are ordered slowest
    node first (ascending ``SubCluster.node_scales``), and data-shard ``i``
    runs on ``devices[i*tp:(i+1)*tp]`` — so the caller must order
    ``devices`` by ascending node efficiency or the uneven shards land on
    the wrong nodes and execute *slower* than even sharding.

    ``hierarchy_nodes``: materialize the three-dim
    :func:`hierarchical_sync_axes` layout instead (stages whose gradient
    sync lowers to the two-level hierarchy) — same device order, the data
    dim merely split as ``node x data``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    axes = hierarchical_sync_axes(plan, hierarchy_nodes) \
        if hierarchy_nodes is not None else intra_op_mesh_axes(plan)
    if not dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is not initialised; call init_process_group "
            "(one rank per device) before building a stage's mesh")
    devices = list(range(dist.get_world_size()) if devices is None else devices)
    need = plan.n_devices
    if len(devices) < need:
        raise ValueError(
            f"plan needs {need} devices (tp={plan.tp} x dp={plan.dp}), "
            f"got {len(devices)}")
    grid = torch.tensor(devices[:need], dtype=torch.int64).reshape(
        [size for _, size in axes])
    return DeviceMesh(device_type, grid,
                      mesh_dim_names=tuple(name for name, _ in axes))


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


def cache_pspecs(cache_tree, rules: Dict[str, Optional[object]]) -> Any:
    """KV-cache / SSM-state specs.

    KV leaves: (L..., B, S, KV, D) -> (batch, kv_seq, kv_heads) rules on the
    trailing 4 dims.  SSM state leaves: 's' (L..., B, H, P, N), 'conv'
    (L..., B, K, C)."""
    def one(path, leaf):
        name = path[-1]
        if name == "s":
            spec = (rules["batch"], rules["heads"], None, None)
        elif name == "conv":
            spec = (rules["batch"], None, rules["ff"])
        else:  # k / v / mem_k / mem_v and grouped variants
            spec = (rules["batch"], rules["kv_seq"], rules["kv_heads"], None)
        return (*([None] * (len(leaf.shape) - len(spec))), *spec)
    return _map_with_path(one, cache_tree)
