"""The single-GPU train step.

Counterpart of ``repro/train/step.py:make_train_step`` (single pod).  The
multi-pod ``make_pipeline_train_step`` comes with the multi-GPU slice
(ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import build_model
from repro_torch.train.optimizer import (
    OptimizerConfig, make_optimizer, tree_leaves, tree_map, tree_unflatten,
)

_INT_KEYS = ("tokens", "labels")


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy or tensor batch -> tensors on ``device``; token ids and labels
    as int64."""
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        out[k] = t.to(device=device, dtype=torch.int64 if k in _INT_KEYS else None)
    return out


def value_and_grad(loss_fn, params, batch) -> Tuple[torch.Tensor, Dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a tree of tensors:
    -> (loss, metrics, grads), grads in the tree's structure.  The params'
    own ``requires_grad`` flags are left alone (gradients flow to detached
    aliases of the same storage).  A leaf the loss does not reach raises,
    so a kernel output cut off from autograd cannot train on zero grads."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(alias, batch)
        leaves = tree_leaves(alias)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: OptimizerConfig, *,
                    param_dtype=torch.float32, n_microbatches: int = 1,
                    use_kernels: bool = True, remat: bool = True,
                    device: DeviceLike = None):
    """Returns (train_step, model, opt_init).

    train_step(params, opt_state, batch) -> (params, opt_state, metrics),
    with params and opt_state updated in place.  ``n_microbatches > 1``
    accumulates f32 gradients over equal slices of the batch, then divides
    gradients, loss and metrics by their count, as the reference does."""
    model = build_model(cfg, use_kernels=use_kernels, remat=remat,
                        param_dtype=param_dtype, device=device)
    opt_init, opt_update = make_optimizer(opt_cfg)

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, model.device)
        if n_microbatches == 1:
            loss, metrics, grads = value_and_grad(model.loss, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            ms = []
            for mb in range(n_microbatches):
                mb_batch = {k: x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                                         *x.shape[1:])[mb] for k, x in batch.items()}
                l, m, g = value_and_grad(model.loss, params, mb_batch)
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi)
                del g
                loss = loss + l
                ms.append(m)
            for acc in tree_leaves(grads):
                acc.div_(n_microbatches)
            loss = loss / n_microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        params, opt_state, om = opt_update(grads, opt_state, params)
        return params, opt_state, {"total_loss": loss, **metrics, **om}

    return train_step, model, opt_init
