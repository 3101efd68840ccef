"""Unified model API, every family: dense, MoE, SSM, hybrid, VLM and audio.

Counterpart of ``repro/models/api.py``: ``build_model(cfg)`` returns a
:class:`Model` of plain functions ``init / forward / loss / init_cache /
decode_step`` bound to one device, dispatching on ``cfg.family``.  The
VLM's batches also hold ``image_embeds`` and the audio family's ``frames``
(:func:`modality_inputs`).  The reference's ``input_specs`` /
``cache_specs`` / ``param_specs``, which only its launcher's dry run uses,
come with the port's launcher.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import (
    encdec, hybrid_lm, mamba_lm, moe_lm, transformer, vlm,
)
from repro_torch.models.common import softmax_cross_entropy
from repro_torch.models.prefill import check_family

_FAMILY = {"dense": transformer, "moe": moe_lm, "ssm": mamba_lm,
           "hybrid": hybrid_lm, "vlm": vlm, "audio": encdec}

# the stub frontends' inputs beside the tokens: (batch key, row count)
MODALITY = {"vlm": ("image_embeds", "n_image_tokens"),
            "audio": ("frames", "enc_frames")}


def modality_inputs(cfg: ArchConfig, batch: int,
                    gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The family's stub-frontend input, ``{"image_embeds": (B,
    n_image_tokens, d)}`` or ``{"frames": (B, enc_frames, d)}``, drawn as
    0.02 N(0, 1) f32 on the generator's device, as the reference's
    ``generate`` draws it; ``{}`` for the token-only families."""
    if cfg.family not in MODALITY:
        return {}
    key, rows = MODALITY[cfg.family]
    shape = (batch, getattr(cfg, rows), cfg.d_model)
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return {key: x.mul_(0.02)}


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
