"""Train steps for both execution modes.

Counterpart of ``repro/train/step.py``:

``make_train_step``          — single pod: DP(+FSDP) over ``data``, TP over
                               ``model`` when the params are DTensors on a
                               ``DeviceMesh``, one GPU when they are plain
                               tensors; grad-accumulated microbatching.
``make_pipeline_train_step`` — multi-pod: the paper's design, a microbatch
                               pipeline over stages (``parallel/pipeline.py``)
                               whose stages run in one process
                               (``LocalTransport``) or one per rank of a
                               ``torch.distributed`` group
                               (``DistributedTransport``).

``make_train_step`` on DTensor params computes on DTensors: the mesh of
the params is ambient and the activation rules place activations
(``models.common.sharded_execution``).  ``make_pipeline_train_step(mesh=...)``
runs one stage per coordinate of the mesh's ``pod`` dim, each rank on
DTensors over its ``(data, model)`` sub-mesh (``stage_submesh``), as the
reference's ``shard_map`` is manual over ``pod`` and leaves ``data`` and
``model`` to GSPMD: ``place_stage`` cuts each rank's shards of the staging
from the caller's host params, the transport moves the carry between the
ranks of a ``pod`` group and reduces the loss sums and shared gradients
over it.  ``abstract=True`` is the reference's dry-run staging: built from
``meta`` structs and placed nowhere (``launch/dryrun.py`` fits the
shardings and places the arguments).  ``train_shardings`` and
``pipeline_shardings(staging, mesh)`` give the
:class:`~repro_torch.parallel.sharding.NamedSharding` trees of the params
and AdamW state, which ``checkpoint.ckpt.reshard`` and
``NamedSharding.distribute`` place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, generator
from repro_torch.models import build_model, param_specs
from repro_torch.models.common import mesh_of, sharded_execution
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import (
    DistributedTransport, LocalTransport, pipeline_loss_fn,
)
from repro_torch.parallel.staging import build_staging, microbatches
from repro_torch.train.optimizer import (
    OptimizerConfig, make_optimizer, placed_like, tree_leaves, tree_map,
    tree_unflatten,
)

_INT_KEYS = ("tokens", "labels")


def batch_pspecs(batch_tree, batch_axes=("data",)) -> Any:
    """Tokens/labels (B, T) -> shard batch dim; modality stubs likewise."""
    ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    return tree_map(lambda x: (ax, *([None] * (len(x.shape) - 1))), batch_tree)


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy or tensor batch -> tensors on ``device``; token ids and labels
    as int64.  DTensor leaves, already placed on their mesh, pass as they
    are."""
    out = {}
    for k, x in batch.items():
        if isinstance(x, DTensor):
            out[k] = x
            continue
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        out[k] = t.to(device=device, dtype=torch.int64 if k in _INT_KEYS else None)
    return out


def value_and_grad(loss_fn, params, batch) -> Tuple[torch.Tensor, Dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a tree of tensors:
    -> (loss, metrics, grads), grads in the tree's structure.  The params'
    own ``requires_grad`` flags are left alone (gradients flow to detached
    aliases of the same storage).  A leaf the loss does not reach raises,
    so a kernel output cut off from autograd cannot train on zero grads;
    only an empty leaf (a stack of no layers, e.g. the hybrid's tail when
    n_layers is a multiple of ``shared_attn_every``) gets its empty
    gradient."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(alias, batch)
        leaves = [p for p in tree_leaves(alias) if p.numel()]
        grads = iter(torch.autograd.grad(loss, leaves))
    grads = [next(grads) if p.numel() else torch.zeros_like(p)
             for p in tree_leaves(alias)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                    act_rules: Optional[Dict] = None,
                    param_dtype=torch.float32, n_microbatches: int = 1,
                    use_kernels: bool = True, remat: bool = True,
                    device: DeviceLike = None):
    """Returns (train_step, model, opt_init).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    with params and opt_state updated in place.  ``n_microbatches > 1``
    accumulates f32 gradients over equal slices of the batch, then divides
    gradients, loss and metrics by their count, as the reference does.

    On DTensor params the step runs under their mesh and ``act_rules``
    (default ``train_act_rules()``), with the batch's leaves DTensors
    sharded on dim 0.  The gradient of a param replicated over ``data``
    comes out of each microbatch's backward as a ``Partial`` sum; the
    accumulator keeps it so, and the one reduction over ``data`` happens
    in the optimizer update, after accumulation, where the reference's
    happens too.  A param sharded over ``data`` (FSDP) has its gradient
    reduce-scattered in every microbatch's backward, by the backward of
    the all-gather that its use needed."""
    model = build_model(cfg, use_kernels=use_kernels, remat=remat,
                        param_dtype=param_dtype, device=device)
    opt_init, opt_update = make_optimizer(opt_cfg)
    rules = act_rules or shd.train_act_rules()

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, model.device)
        with sharded_execution(mesh_of(params), rules):
            if n_microbatches == 1:
                loss, metrics, grads = value_and_grad(model.loss, params, batch)
            else:
                grads = None
                ms = []
                parts = {k: microbatches(x, n_microbatches) for k, x in batch.items()}
                for mb in range(n_microbatches):
                    mb_batch = {k: v[mb] for k, v in parts.items()}
                    l, m, g = value_and_grad(model.loss, params, mb_batch)
                    if grads is None:
                        grads = tree_map(
                            lambda gi: gi.to(torch.float32, copy=True), g)
                        loss = l.float()
                    else:
                        for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                            acc.add_(gi)
                        loss = loss + l
                    del g
                    ms.append(m)
                for acc in tree_leaves(grads):
                    acc.div_(n_microbatches)
                loss = loss / n_microbatches
                metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
            params, opt_state, om = opt_update(grads, opt_state, params)
        return params, opt_state, {"total_loss": loss, **metrics, **om}

    return train_step, model, opt_init


def _dim0(axes, spec):
    return (axes, *([None] * (len(spec) - 1))) if len(spec) else spec


def layout_specs(pspecs, *, fsdp_params: bool = True, flat_dp: bool = False):
    """(param specs, optimizer-state specs) of a layout, from the param
    rules' specs (``sharding.param_pspecs``), as the reference's launcher
    derives them:

    - default (``fsdp_params``): both as the rules say (FSDP over
      ``data``, TP over ``model``);
    - ZeRO-1 (``fsdp_params=False``): params replicated over ``data``, the
      state sharded over it: as the rule says where it names ``data``,
      else on dim 0 where the rule leaves that whole.  The reference puts
      ``data`` on dim 0 of every leaf, so a stacked leaf whose rule already
      names ``data`` on its dim 1 names the axis twice, which its
      ``NamedSharding`` refuses wherever the layer count divides ``data``
      (ROADMAP.md, Queue 3); both give the same placement wherever
      ``fit_spec`` drops dim 0's ``data``;
    - flat DP (``flat_dp``): no TP; params dim 0 over ``("data",
      "model")`` with ``fsdp_params``, else replicated; the state dim 0
      over the pair."""
    if flat_dp:
        pair = ("data", "model")
        params = (tree_map(lambda sp: _dim0(pair, sp), pspecs) if fsdp_params
                  else tree_map(lambda sp: (None,) * len(sp), pspecs))
        return params, tree_map(lambda sp: _dim0(pair, sp), pspecs)
    if fsdp_params:
        return pspecs, pspecs
    params = tree_map(lambda sp: tuple(None if e == "data" else e for e in sp), pspecs)
    def state(sp):
        if any("data" in shd._entry_axes(e) for e in sp):
            return sp
        return tuple(("data" if e is None else e) if i == 0 else e
                     for i, e in enumerate(sp))
    return params, tree_map(state, pspecs)


def train_shardings(cfg: ArchConfig, mesh, opt_init, model):
    """(param_shardings, opt_shardings) :class:`NamedSharding` trees of
    ``model``'s params and ``opt_init``'s state in the default layout
    (:func:`layout_specs`): ``mu``, ``nu`` (and ``master``) mirror the
    params, the step counter is replicated.  Shapes come from
    ``model.init`` and ``opt_init`` under ``FakeTensorMode``, which
    allocates nothing.  ``cfg`` keeps the reference's signature; the model
    carries it.  Not fitted, as the reference's: a spec whose mesh dims do
    not divide its dim is refused when placed (``sharding.fitted_shardings``
    fits one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = model.init(generator(model.device, 0))
        opt_shape = opt_init(params)
    named = tree_map(lambda s: shd.NamedSharding(mesh, s), shd.param_pspecs(params))
    opt_shard = type(opt_shape)(
        shd.NamedSharding(mesh, ()), named, named,
        named if opt_shape.master is not None else None)
    return named, opt_shard


# ---------------------------------------------------------------------------
# multi-pod (pipeline over stages)
# ---------------------------------------------------------------------------


def stage_submesh(mesh):
    """(sub-mesh, stage) of this rank on a ``("pod", ...)`` mesh: the mesh
    of its other dims (``mesh["data", "model"]``) that its stage computes
    over, and its coordinate on ``pod``, the stage it runs."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        raise ValueError(f"the mesh has no 'pod' dim: {shd.mesh_axis_sizes(mesh)}")
    rest = tuple(n for n in names if n != "pod")
    if not rest:
        raise ValueError(f"the mesh {names} has no dim for a stage to compute over")
    return mesh[rest], mesh.get_coordinate()[names.index("pod")]


def place_stage(tree, specs, mesh, device: DeviceLike = None):
    """This rank's part of ``tree``, a staging tree of whole tensors (every
    stage, on any device: the host's, say) placed by the spec tree ``specs``
    (``pipeline_shardings``' specs, or ``layout_specs`` of them): each leaf
    cut to this rank's stage where its spec names ``pod`` (the stage dim,
    kept with size 1), then to this rank's shard on its sub-mesh
    (:func:`stage_submesh`) by the rest of the spec, as a DTensor on
    ``device``.  Only that shard is copied; its local shape is
    ``NamedSharding(mesh, spec).shard_shape`` of the whole leaf."""
    from repro_torch.device import resolve_device

    sub, stage = stage_submesh(mesh)
    n_pod = mesh.size(tuple(mesh.mesh_dim_names).index("pod"))
    dev = resolve_device(device)

    def one(x, spec):
        for d, entry in enumerate(spec):
            if entry == "pod":
                n = x.shape[d] // n_pod
                x = x.narrow(d, stage * n, n)
            elif "pod" in shd._entry_axes(entry):
                raise ValueError(f"spec {spec} splits dim {d} over 'pod' and "
                                 "other dims; a stage holds a whole stage dim")
        spec = tuple(None if e == "pod" else e for e in spec)
        return shd.NamedSharding(sub, spec).distribute(x, dev)

    return tree_map(one, tree, specs)


def make_pipeline_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                             n_stages: int, n_microbatches: int,
                             param_dtype=torch.float32,
                             act_dtype=torch.bfloat16,
                             params: Any = None, use_kernels: bool = True,
                             device: DeviceLike = None, transport=None,
                             mesh=None, abstract: bool = False):
    """Returns (train_step, staging, opt_init, shardings).

    train_step(staged, shared, consts, opt_state, batch) -> (staged, shared,
    opt_state, metrics) takes the gradient of the pipeline's loss over
    ``{"staged", "shared"}`` and applies AdamW to that tree, in place.
    ``transport`` of ``None`` is a
    :class:`~repro_torch.parallel.pipeline.LocalTransport`.  ``params`` are
    in the model's layout, on any device (the host's memory, say); the
    staging's trees are placed on the model's device.  With the local
    transport ``params=None`` means ``model.init`` from a generator seeded 0
    on that device.  With a ``DistributedTransport`` the caller passes
    ``params``, and only this rank's stage of ``staged`` and ``consts`` (a
    leading dim of 1, copied) and the shared trees reach the device: a
    rank that drew the whole model there would need the memory that a
    pipeline exists to split.

    A ``mesh`` (a ``DeviceMesh`` with a ``pod`` dim, as the reference's,
    and the dims a stage computes over: ``("pod", "data", "model")``) gives
    a ``DistributedTransport`` over its ``pod`` group, and the shardings
    then hold its ``NamedSharding`` trees too.  Each rank runs its stage on
    DTensors over its ``(data, model)`` sub-mesh, as the reference's GSPMD
    runs a stage's body: ``staged``, ``consts`` and ``shared`` are placed by
    ``pipeline_shardings`` (:func:`place_stage`: each rank copies its own
    shards from ``params``), a batch of whole host arrays is cut to this
    rank's rows of the ``data`` dim, and activations are placed by
    ``train_act_rules()``.  The gradients are brought to their parameters'
    placements before the shared ones are summed over ``pod``; AdamW then
    updates the DTensors where they lie, in whatever layout the caller
    placed them (``layout_specs``; ``opt_init`` keeps the params'
    placements).  The sub-mesh path runs the plain path: a kernel refuses
    a DTensor, so a ``mesh`` with ``use_kernels=True`` raises here.

    ``abstract=True`` (the dry run, as the reference's) builds the staging
    from ``models.param_specs`` on ``meta`` and allocates nothing: the
    staging's trees stay whole ``meta`` structs (every stage, the stage
    dim leading), nothing is placed, and the shardings are
    ``pipeline_shardings(staging, mesh)``, unfitted, as the reference's:
    the caller (the dry run) fits them and places the arguments; the step
    takes them as any other."""
    sub = None
    if mesh is not None:
        if transport is not None:
            raise ValueError("pass a mesh or a transport, not both")
        sub, _ = stage_submesh(mesh)
        if use_kernels:
            raise ValueError(
                "a stage on a mesh computes on DTensors, which a kernel "
                "refuses: pass use_kernels=False (the plain path, as the "
                "reference's mesh pipeline runs its jnp path)")
        transport = DistributedTransport(group=mesh.get_group("pod"))
    model = build_model(cfg, use_kernels=use_kernels, param_dtype=param_dtype,
                        device=device)
    dev = model.device
    transport = LocalTransport() if transport is None else transport
    stages = transport.stage_ids(n_stages)
    lo, n = stages[0], len(stages)
    if abstract:
        if params is not None:
            raise ValueError("abstract=True builds the staging from shape "
                             "structs: pass no params")
        params = param_specs(cfg, param_dtype=param_dtype)
    elif params is None:
        if n < n_stages:
            raise ValueError(
                f"a rank holding {n} of {n_stages} stages takes the model's "
                "params from the caller (on the host, say): drawing them "
                "here would put the whole model on its device")
        params = model.init(generator(dev, 0))
    staging = build_staging(cfg, n_stages, params, act_dtype=act_dtype,
                            use_kernels=use_kernels)
    del params
    specs = pipeline_shardings(staging)
    if abstract:
        pass                # the caller places the arguments
    elif sub is not None:
        for name in ("staged", "shared", "consts"):
            setattr(staging, name, place_stage(getattr(staging, name),
                                               specs[name], mesh, dev))
    else:
        def place(x):
            return x[lo:lo + n].to(dev, copy=True) if n < n_stages else x.to(dev)

        staging.staged = tree_map(place, staging.staged)
        staging.consts = tree_map(place, staging.consts)
        staging.shared = tree_map(lambda x: x.to(dev), staging.shared)

    opt_init, opt_update = make_optimizer(opt_cfg)
    loss_fn = pipeline_loss_fn(staging, n_microbatches, transport)
    rules = shd.train_act_rules()

    def train_step(staged, shared, consts, opt_state, batch):
        batch = (batch_to_device(batch, dev) if sub is None
                 else _place_batch(batch, sub, dev))
        tree = {"staged": staged, "shared": shared}
        with sharded_execution(sub, rules):
            loss, metrics, grads = value_and_grad(
                lambda t, b: loss_fn(t["staged"], t["shared"], consts, b),
                tree, batch)
            grads = tree_map(placed_like, grads, tree)
            transport.sum_shared_grads(grads["shared"])
            tree, opt_state, om = opt_update(grads, opt_state, tree,
                                             grad_norm=transport.grad_norm(grads))
        return tree["staged"], tree["shared"], opt_state, \
            {"total_loss": loss, **metrics, **om}

    return train_step, staging, opt_init, pipeline_shardings(staging, mesh)


def _place_batch(batch, sub, dev) -> Dict[str, torch.Tensor]:
    """A batch on the sub-mesh ``sub``: whole arrays (token ids and labels
    as int64, on the host) cut to this rank's rows of ``data``; DTensor
    leaves, already placed, as they are."""
    host = batch_to_device(batch, torch.device("cpu"))
    shardings = shd.batch_shardings(sub, host, "data")
    return {k: x if isinstance(x, DTensor) else shardings[k].distribute(x, dev)
            for k, x in host.items()}


def pipeline_shardings(staging, mesh=None) -> Dict[str, Any]:
    """Spec trees (tuples of mesh-axis names and ``None``) of the staging's
    three parameter trees: stage dim on ``pod`` for ``staged`` and
    ``consts``, the single-pod rules for ``shared``.  With a ``mesh``, as
    the reference's: ``staged`` / ``shared`` / ``consts`` are their
    ``NamedSharding`` trees and the specs move to ``staged_specs`` /
    ``shared_specs`` / ``consts_specs``."""
    specs = {
        "staged": shd.staged_param_pspecs(staging.staged),
        "shared": shd.param_pspecs(staging.shared),
        "consts": tree_map(lambda x: ("pod", *([None] * (x.dim() - 1))),
                           staging.consts),
    }
    if mesh is None:
        return specs
    return {**{name: tree_map(lambda s: shd.NamedSharding(mesh, s), tree)
               for name, tree in specs.items()},
            **{f"{name}_specs": tree for name, tree in specs.items()}}
