"""Unified model API, dense and SSM families.

Counterpart of ``repro/models/api.py``: ``build_model(cfg)`` returns a
:class:`Model` of plain functions ``init / forward / loss / init_cache /
decode_step`` bound to one device, dispatching on ``cfg.family``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mamba_lm, transformer
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.prefill import check_family

_FAMILY = {"dense": transformer, "ssm": mamba_lm}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    device: torch.device
    init: Callable[..., Any]             # (generator) -> params
    forward: Callable[..., Any]          # (params, batch) -> (logits, aux)
    loss: Callable[..., Any]             # (params, batch) -> (scalar, metrics)
    init_cache: Callable[..., Any]       # (batch, seq_len, dtype) -> cache
    decode_step: Callable[..., Any]      # (params, cache, tokens, pos) -> (logits, cache)


def build_model(cfg: ArchConfig, *, use_kernels: bool = True,
                remat: bool = True, param_dtype=torch.float32,
                device: DeviceLike = None) -> Model:
    """``device`` of None means ``cuda`` (raises without a card)."""
    check_family(cfg)
    mod = _FAMILY[cfg.family]
    dev = resolve_device(device)

    def init_fn(gen: torch.Generator):
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return mod.init(cfg, gen, dtype=param_dtype)

    def forward_fn(params, batch):
        return mod.forward(cfg, params, batch, use_kernels=use_kernels,
                           remat=remat)

    def loss_fn(params, batch):
        logits, aux = forward_fn(params, batch)
        per_tok, acc = softmax_cross_entropy(logits, batch["labels"])
        mask = batch.get("loss_mask")
        if mask is None:
            loss = per_tok.mean()
            accuracy = acc.mean()
        else:
            mask = mask.to(per_tok.dtype)
            denom = torch.clamp(mask.sum(), min=1.0)
            loss = (per_tok * mask).sum() / denom
            accuracy = (acc * mask).sum() / denom
        total = loss + aux
        return total, {"loss": loss, "aux_loss": aux, "accuracy": accuracy}

    def init_cache_fn(batch, seq_len, dtype=torch.bfloat16):
        return mod.init_cache(cfg, batch, seq_len, dtype, device=dev)

    def decode_fn(params, cache, tokens, pos):
        return mod.decode_step(cfg, params, cache, tokens, pos)

    return Model(cfg=cfg, device=dev, init=init_fn, forward=forward_fn,
                 loss=loss_fn, init_cache=init_cache_fn, decode_step=decode_fn)
