"""Gradient compression for slow (cross-pod) reductions: int8 block
quantization with error feedback.

Counterpart of ``repro/parallel/compression.py``, on tensors of any device.
Beyond-paper distributed-optimization trick (HAPT avoids cross-cluster
collectives entirely; when a deployment *does* reduce gradients across the
DCN — e.g. zamba2's shared block whose parameters live on every stage — 4x
smaller payloads matter).  Error feedback keeps the quantization bias out of
the optimizer: the residual (g - dequant(quant(g))) is added to the next
step's gradient, which provably preserves SGD convergence.

The arithmetic runs in the reference's order (f32 cast, zero pad to whole
blocks, ``amax / 127``, a zero scale replaced by 1, round half to even, clip
to ±127, int8), every division correctly rounded, so ``q`` and the scales
are bit-equal to the reference's, on the CPU and on a card alike.
Trees are nested dicts; a payload leaf is a ``(q, scale)`` tuple.  The wire
bytes of a payload are what ``repro_torch.comm.selector.
compressed_wire_bytes`` prices.  No training path calls this module.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.train.optimizer import tree_map

BLOCK = 256


def _pad_len(n: int) -> int:
    return (-n) % BLOCK


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. Returns (q, scales):
    ``q`` (n_blocks, BLOCK) int8, ``scales`` (n_blocks,) f32."""
    flat = g.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, _pad_len(flat.numel())))
    blocks = flat.reshape(-1, BLOCK)
    amax = torch.amax(torch.abs(blocks), dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with its
    # rounded reciprocal, which is not always the correctly rounded quotient
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def init_error_feedback(grads) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def compress_tree(grads, err_fb):
    """Apply error feedback + quantize each leaf.  Returns (payload, new_err).

    payload leaves are (q, scale) pairs — 4x smaller on the wire than f32."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        q, s = quantize_int8(corrected)
        return (q, s), corrected - dequantize_int8(q, s, g.shape)

    both = tree_map(one, grads, err_fb)
    return tree_map(lambda pe: pe[0], both), tree_map(lambda pe: pe[1], both)


def decompress_tree(payload, template):
    return tree_map(lambda t, qs: dequantize_int8(qs[0], qs[1], t.shape, t.dtype),
                template, payload)


def wire_bytes(payload) -> int:
    """Bytes of a payload on the wire: every ``q`` and scale."""
    if isinstance(payload, dict):
        return sum(wire_bytes(v) for v in payload.values())
    q, s = payload
    return q.numel() * q.element_size() + s.numel() * s.element_size()
