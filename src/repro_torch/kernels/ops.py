"""Public entry points of the port's kernels, in the model layout.

Counterpart of ``repro/kernels/ops.py``: the tuned-block registry (same op
names and shape keys) and ``flash_attention`` with its gradient.  Launch
counts are in ``repro_torch.kernels.LAUNCHES``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa

# ---------------------------------------------------------------------------
# Tuned-block registry
#
# Entry points called with block sizes of ``None`` resolve through this table
# (exact shape, else nearest same-rank shape by log-distance) and fall back
# to the kernel's defaults when nothing is installed.
# Shape keys per op: flash_attention (B, T, S, H, KV, D); rmsnorm (rows, D).
# ---------------------------------------------------------------------------

_TUNED_BLOCKS: dict = {}


def set_tuned_blocks(op: str, shape, blocks) -> None:
    _TUNED_BLOCKS.setdefault(op, {})[tuple(int(d) for d in shape)] = tuple(
        int(b) for b in blocks)


def clear_tuned_blocks(op: Optional[str] = None) -> None:
    if op is None:
        _TUNED_BLOCKS.clear()
    else:
        _TUNED_BLOCKS.pop(op, None)


def tuned_blocks(op: str, shape):
    """Best-known block config for ``op`` at ``shape`` (None if untuned)."""
    entries = _TUNED_BLOCKS.get(op)
    if not entries:
        return None
    shape = tuple(int(d) for d in shape)
    hit = entries.get(shape)
    if hit is not None:
        return hit
    same_rank = [s for s in entries if len(s) == len(shape)]
    if not same_rank:
        return None

    def dist(s):
        return sum(abs(math.log2(max(a, 1)) - math.log2(max(b, 1)))
                   for a, b in zip(s, shape))

    best = min(same_rank, key=lambda s: (dist(s), s))
    return entries[best]


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention in model layout. q: (B, T, H, D); k, v: (B, S, KV, D).

    Differentiable on both devices through :class:`FlashAttention`: the
    forward kernel, and the dq and dk/dv kernels for the backward.
    ``block_q``/``block_k`` of None resolve through the tuned-block registry
    and default to the kernel's own choice when untuned."""
    if block_q is None or block_k is None:
        B, T, H, D = q.shape
        S, KV = k.shape[1], k.shape[2]
        tuned = tuned_blocks("flash_attention", (B, T, S, H, KV, D))
        tq, tk = tuned if tuned else _fa.default_blocks(D)
        block_q = tq if block_q is None else block_q
        block_k = tk if block_k is None else block_k
    return _fa.FlashAttention.apply(q, k, v, causal, window, block_q, block_k)
