"""AdamW as a pure-looking (init, update) pair with dtype-configurable state.

Counterpart of ``repro/train/optimizer.py``, with the same formulas:
``lr_schedule`` takes the step before the increment, the clip scale is
``min(1, clip / (gn + 1e-9))``, weight decay applies only to leaves with
``ndim >= 2``, and the ``state_dtype`` and ``master_weights`` modes keep
their meaning.  Unlike the reference, ``update`` works leaf by leaf IN
PLACE: the returned params and state are the tensors passed in, updated, so
temporaries stay within about two of the largest leaf (gpt-2b's stacked MLP
input weight is 3.36 GB in f32).  The step, lr, clip scale and grad norm
stay 0-d tensors on the parameters' device, so an update never waits on
the card.

On DTensor params the state keeps their placements (``zeros_like``; the
step counter is replicated), and ``update`` first brings each gradient to
its state's placement, one collective per leaf (a ``Partial`` gradient is
all-reduced, or reduce-scattered where the state is sharded), before the
norm and the update read it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory
    master_weights: bool = False      # params bf16 + f32 master in the state
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor                # int32, 0-d
    mu: Any
    nu: Any
    master: Any = None                # f32 master copy (master_weights mode)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict of tensors, in sorted-key order (the order
    of the reference's pytree flattening)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """Inverse of :func:`tree_leaves`: ``template``'s structure with
    ``leaves`` (an iterable in sorted-key order) as its leaves."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)
    return build(template)


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, in f32 on ``step``'s device."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def _step_counter(like: torch.Tensor) -> torch.Tensor:
    """A 0-d int32 zero on ``like``'s device; replicated over its mesh when
    ``like`` is a DTensor."""
    zero = torch.zeros((), dtype=torch.int32, device=like.device)
    if isinstance(like, DTensor):
        mesh = like.device_mesh
        return distribute_tensor(zero, mesh, [Replicate()] * mesh.ndim)
    return zero


def _placed_like(g: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``g`` redistributed to ``ref``'s placements when both are DTensors
    and they differ; else ``g``."""
    if (isinstance(g, DTensor) and isinstance(ref, DTensor)
            and tuple(g.placements) != tuple(ref.placements)):
        return g.redistribute(ref.device_mesh, ref.placements)
    return g


def make_adamw(cfg: OptimizerConfig):
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=cfg.state_dtype)
        master = (tree_map(lambda p: p.detach().float().clone(), params)
                  if cfg.master_weights else None)
        return OptState(_step_counter(tree_leaves(params)[0]),
                        tree_map(zeros, params), tree_map(zeros, params), master)

    @torch.no_grad()
    def update(grads, state: OptState, params, grad_norm=None
               ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
        """Consumes ``grads`` (their f32 leaves are scaled in place).
        ``grad_norm`` replaces ``global_norm(grads)`` for clipping where
        ``grads`` is one part of a larger tree (a pipeline stage's)."""
        grads = tree_map(_placed_like, grads, state.mu)
        step = state.step + 1
        gn = global_norm(grads) if grad_norm is None else grad_norm
        scale = (torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
                 if cfg.grad_clip else None)
        lr = lr_schedule(cfg, state.step)
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()
        source = state.master if cfg.master_weights else params
        for g, m, v, pm, p in zip(*(tree_leaves(t) for t in (
                grads, state.mu, state.nu, source, params))):
            g = g.float()                     # a copy unless g is f32
            if scale is not None:
                g.mul_(scale)
            m32 = m if m.dtype == torch.float32 else m.float()
            m32.mul_(b1).add_((1 - b1) * g)
            v32 = v if v.dtype == torch.float32 else v.float()
            v32.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            delta = torch.sqrt(v32 / c2).add_(cfg.eps)
            delta = torch.div(m32 / c1, delta, out=delta)
            if pm.dim() >= 2 and cfg.weight_decay:       # none on norms
                delta.add_(cfg.weight_decay * pm.float())
            if pm.dtype == torch.float32:
                pm.sub_(delta.mul_(lr))
            else:
                pm.copy_(pm.float() - lr * delta)
            del delta
            if m32 is not m:
                m.copy_(m32)
            if v32 is not v:
                v.copy_(v32)
            if pm is not p:
                p.copy_(pm)
        state.step.copy_(step)
        return params, state, {"grad_norm": gn, "lr": lr}

    return init, update


def make_optimizer(cfg: OptimizerConfig):
    if cfg.name == "adamw":
        return make_adamw(cfg)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
