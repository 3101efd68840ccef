"""Unified model API, every family: dense, MoE, SSM, hybrid, VLM and audio.

Counterpart of ``repro/models/api.py``: ``build_model(cfg)`` returns a
:class:`Model` of plain functions ``init / forward / loss / init_cache /
decode_step`` bound to one device, dispatching on ``cfg.family``.  The
VLM's batches also hold ``image_embeds`` and the audio family's ``frames``
(:func:`modality_inputs`).  :func:`input_specs`, :func:`cache_specs` and
:func:`param_specs` are the reference's stand-ins for the launcher's dry
run: ``meta`` tensors of the same shapes and dtypes, leaf for leaf, which
allocate nothing.  Their tokens are int32, as the reference's; the port's
real batches carry int64 ids (``train.step.batch_to_device``), and the
model code takes either.
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
from repro_torch.models.common import pin_grad, softmax_cross_entropy
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
        per_tok = pin_grad(per_tok)
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


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins: no allocation)
# ---------------------------------------------------------------------------


def _meta(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")


def _tree_meta(tree):
    if isinstance(tree, dict):
        return {k: _tree_meta(v) for k, v in tree.items()}
    return _meta(tree)


def input_specs(cfg: ArchConfig, shape, act_dtype=torch.bfloat16
                ) -> Dict[str, torch.Tensor]:
    """Batch input stand-ins for (arch, shape) as ``meta`` tensors.

    train/prefill: int32 token batch (+ labels for train, + the modality
    stub in ``act_dtype``).  decode: one int32 token per sequence and the
    int32 position; the KV cache / SSM state is :func:`cache_specs`'s."""
    B, T = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": spec((B, T), i32)}
        if shape.kind == "train":
            specs["labels"] = spec((B, T), i32)
        if cfg.family in MODALITY:
            key, rows = MODALITY[cfg.family]
            specs[key] = spec((B, getattr(cfg, rows), cfg.d_model), act_dtype)
        return specs
    return {"tokens": spec((B, 1), i32), "pos": spec((), i32)}


def cache_specs(cfg: ArchConfig, shape, dtype=torch.bfloat16) -> Any:
    """``meta`` stand-ins of the KV cache / SSM state of a decode cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(cfg, device="cpu")
    with FakeTensorMode():
        cache = model.init_cache(shape.global_batch, shape.seq_len, dtype)
    return _tree_meta(cache)


def param_specs(cfg: ArchConfig, param_dtype=torch.float32) -> Any:
    """``meta`` stand-ins of the parameter tree: ``model.init`` under
    ``FakeTensorMode``, so nothing is drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.device import generator

    model = build_model(cfg, param_dtype=param_dtype, device="cpu")
    with FakeTensorMode():
        params = model.init(generator(model.device, 0))
    return _tree_meta(params)
