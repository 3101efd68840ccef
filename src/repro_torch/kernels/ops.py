"""Public entry points of the port's kernels, in the model layout.

Counterpart of ``repro/kernels/ops.py``: the tuned-block registry (same op
names and shape keys), ``flash_attention`` and ``ssd_intra``, each with its
gradient, and ``rmsnorm`` (forward only, as the reference's).  Launch counts
are in ``repro_torch.kernels.LAUNCHES``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels.ref import ssd_intra_oracle

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


def flash_blocks(shape, elem: int = 4, block_q: Optional[int] = None,
                 block_k: Optional[int] = None):
    """The (block_q, block_k) the forward kernel launches with at ``shape``
    (B, T, S, H, KV, D) and ``elem`` bytes per element.  Blocks of None
    resolve through the tuned-block registry, else the kernel's defaults.  A
    resolved tile the kernel does not take at this head dim (the registry's
    nearest shape may have another one) gives way to the default; explicit
    blocks are kept, and the wrapper refuses them if the kernel cannot
    launch them."""
    D = int(shape[-1])
    default = _fa.default_blocks(D)
    tuned = (tuned_blocks("flash_attention", shape)
             if block_q is None or block_k is None else None)
    for tq, tk in (tuned or default, default):
        bq = tq if block_q is None else block_q
        bk = tk if block_k is None else block_k
        if _fa.tile_fits(D, bq, bk, elem):
            break
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention in model layout. q: (B, T, H, D); k, v: (B, S, KV, D).

    Differentiable on both devices through :class:`FlashAttention`: the
    forward kernel, and the dq and dk/dv kernels for the backward.  The
    forward's blocks come from :func:`flash_blocks`; the backward kernels
    size their own (``bwd_blocks``) and take none from the registry."""
    shape = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3])
    block_q, block_k = flash_blocks(shape, q.element_size(), block_q, block_k)
    return _fa.FlashAttention.apply(q, k, v, causal, window, block_q, block_k)


# ---------------------------------------------------------------------------
# SSD intra-chunk
# ---------------------------------------------------------------------------


class SSDIntra(torch.autograd.Function):
    """Differentiable SSD intra-chunk term, the counterpart of the
    reference's ``custom_vjp`` (``repro/kernels/ops.py:ssd_intra``, whose
    ``bwd`` at ``:208-211`` is the VJP of the jnp oracle).

    The forward is kernel K5 on a CUDA tensor and the plain version on a CPU
    tensor, and saves the five inputs.  The backward recomputes the plain
    oracle under autograd on detached inputs and takes its VJP, as the
    reference does: there is no backward kernel, so it launches none on
    either device."""

    @staticmethod
    def forward(ctx, xc, dtc, cum, Bc, Cc):
        ctx.save_for_backward(xc, dtc, cum, Bc, Cc)
        return _ssd.ssd_intra(xc, dtc, cum, Bc, Cc)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        # a profiler range, so that a trace of a training step separates
        # this VJP from the rest of the block's backward
        # (scripts/torch_profile_fit.py)
        with torch.enable_grad(), torch.profiler.record_function("ssd_intra_vjp"):
            y = ssd_intra_oracle(*inputs)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(inputs, need) if n], g))
        return tuple(next(grads) if n else None for n in need)


def ssd_intra(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """Intra-chunk SSD term in the model layout, f32 (see
    ``kernels/ssd_scan.py:ssd_intra``), differentiable through
    :class:`SSDIntra`."""
    return SSDIntra.apply(xc, dtc, cum, Bc, Cc)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: Optional[int] = None) -> torch.Tensor:
    """x: (..., D) any leading dims; w: (D,).  Output in x's dtype.

    ``block_rows`` of None resolves through the tuned-block registry under
    (rows, D) and defaults to 128.  K4 masks its last row tile, so any block
    works at any row count (the reference halves it until it divides)."""
    shape = x.shape
    D = shape[-1]
    rows = math.prod(shape[:-1])
    if block_rows is None:
        tuned = tuned_blocks("rmsnorm", (rows, D))
        block_rows = tuned[0] if tuned else _rn.DEFAULT_BLOCK_ROWS
    return _rn.rmsnorm(x.reshape(rows, D), w, eps=eps,
                       block_rows=block_rows).reshape(shape)
