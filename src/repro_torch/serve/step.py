"""Serving steps: prefill (build the KV cache or SSM state) and batched decode.

Counterpart of ``repro/serve/step.py``.  On plain tensors the steps run on
one GPU; on DTensor params they run under the params' mesh and the
reference's sharding rules (``parallel/sharding.py``): decode with the batch
over ``(pod?, data)`` and the KV-cache sequence over ``model``, or, at batch
< 16 (long context), the cache sequence over every axis.  Temperature sampling is Gumbel-max, ``argmax(logits / T + g)``, the same
algorithm as ``jax.random.categorical``; the caller threads a
``torch.Generator`` from which ``g`` is drawn.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.device import DeviceLike
from repro_torch.models import build_model
from repro_torch.models.common import argmax_last, mesh_of, sharded_execution
from repro_torch.parallel import sharding as shd


def gumbel_noise(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise on the generator's device, float32."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample_tokens(logits: torch.Tensor, temperature: float,
                  gumbel: torch.Tensor) -> torch.Tensor:
    """logits (B, V), gumbel (B, V) -> (B, 1) tokens: argmax(logits/T + g)."""
    scaled = logits.float() / temperature
    return argmax_last(scaled + gumbel)[..., None]


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) argmax tokens."""
    return argmax_last(logits[:, -1])[..., None]


def make_serve_step(cfg: ArchConfig, *, shape: Optional[ShapeSpec] = None,
                    multi_pod: bool = False, use_kernels: bool = True,
                    greedy: bool = True, temperature: float = 1.0,
                    device: DeviceLike = None):
    """Returns (serve_step, model, rules); serve_step -> (next_tokens (B,1),
    cache).

    ``greedy=True``: ``serve_step(params, cache, tokens, pos)``, argmax
    decoding.  ``greedy=False``: ``serve_step(params, cache, tokens, pos,
    gen)``, temperature sampling with noise drawn from ``gen``.  The cache
    is updated in place.  ``rules`` are ``decode_act_rules`` of
    ``shape.global_batch``; with ``shape`` None they follow each call's
    batch and ``rules`` is None.  They take effect when the params are
    DTensors (``models.common.sharded_execution``)."""
    if not greedy and temperature <= 0.0:
        raise ValueError(
            f"sampling needs temperature > 0, got {temperature} "
            f"(use greedy=True for argmax decoding)")
    model = build_model(cfg, use_kernels=use_kernels, device=device)
    rules = (None if shape is None
             else shd.decode_act_rules(shape.global_batch, multi_pod=multi_pod))

    def context(params, tokens):
        mesh = mesh_of(params)
        if mesh is None:
            return sharded_execution(None, None)
        r = rules or shd.decode_act_rules(tokens.shape[0], multi_pod=multi_pod)
        return sharded_execution(mesh, r)

    if greedy:
        def serve_step(params, cache, tokens, pos):
            with context(params, tokens):
                logits, cache = model.decode_step(params, cache, tokens, pos)
                return greedy_tokens(logits), cache
    else:
        def serve_step(params, cache, tokens, pos, gen):
            with context(params, tokens):
                logits, cache = model.decode_step(params, cache, tokens, pos)
                g = gumbel_noise(logits[:, -1].shape, gen)
                return sample_tokens(logits[:, -1], temperature, g), cache

    return serve_step, model, rules


def make_prefill_step(cfg: ArchConfig, *, multi_pod: bool = False,
                      use_kernels: bool = True, device: DeviceLike = None):
    """Full-sequence forward: returns (prefill_step, model, rules); the step
    maps (params, batch) to logits (B, T, V), under ``prefill_act_rules``
    when the params are DTensors."""
    model = build_model(cfg, use_kernels=use_kernels, device=device)
    rules = shd.prefill_act_rules(multi_pod=multi_pod)

    def prefill_step(params, batch):
        with sharded_execution(mesh_of(params), rules):
            logits, _ = model.forward(params, batch)
        return logits

    return prefill_step, model, rules
