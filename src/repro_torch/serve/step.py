"""Serving steps: prefill (build the KV cache or SSM state) and batched decode.

Counterpart of ``repro/serve/step.py`` on one GPU (no sharding rules).
Temperature sampling is Gumbel-max, ``argmax(logits / T + g)``, the same
algorithm as ``jax.random.categorical``; the caller threads a
``torch.Generator`` from which ``g`` is drawn.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import build_model


def gumbel_noise(shape, gen: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise on the generator's device, float32."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def sample_tokens(logits: torch.Tensor, temperature: float,
                  gumbel: torch.Tensor) -> torch.Tensor:
    """logits (B, V), gumbel (B, V) -> (B, 1) tokens: argmax(logits/T + g)."""
    scaled = logits.float() / temperature
    return torch.argmax(scaled + gumbel, dim=-1, keepdim=True)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) argmax tokens."""
    return torch.argmax(logits[:, -1], dim=-1, keepdim=True)


def make_serve_step(cfg: ArchConfig, *, use_kernels: bool = True,
                    greedy: bool = True, temperature: float = 1.0,
                    device: DeviceLike = None):
    """Returns (serve_step, model); serve_step -> (next_tokens (B,1), cache).

    ``greedy=True``: ``serve_step(params, cache, tokens, pos)``, argmax
    decoding.  ``greedy=False``: ``serve_step(params, cache, tokens, pos,
    gen)``, temperature sampling with noise drawn from ``gen``.  The cache
    is updated in place."""
    if not greedy and temperature <= 0.0:
        raise ValueError(
            f"sampling needs temperature > 0, got {temperature} "
            f"(use greedy=True for argmax decoding)")
    model = build_model(cfg, use_kernels=use_kernels, device=device)

    if greedy:
        def serve_step(params, cache, tokens, pos):
            logits, cache = model.decode_step(params, cache, tokens, pos)
            return greedy_tokens(logits), cache
    else:
        def serve_step(params, cache, tokens, pos, gen):
            logits, cache = model.decode_step(params, cache, tokens, pos)
            g = gumbel_noise(logits[:, -1].shape, gen)
            return sample_tokens(logits[:, -1], temperature, g), cache

    return serve_step, model


def make_prefill_step(cfg: ArchConfig, *, use_kernels: bool = True,
                      device: DeviceLike = None):
    """Full-sequence forward: returns (prefill_step, model); the step maps
    (params, batch) to logits (B, T, V)."""
    model = build_model(cfg, use_kernels=use_kernels, device=device)

    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill_step, model
