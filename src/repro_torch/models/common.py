"""Shared functional building blocks: norms, linears, embeddings, RoPE and
the activation dtype policy.

Counterpart of ``repro/models/common.py``.  Models are plain functions over
explicit parameter dicts of tensors; repeated blocks store parameters
stacked along a leading layer axis, as in the reference, and the forward
pass loops over that axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Activation sharding: a no-op on one GPU, as the reference is without a mesh
# ---------------------------------------------------------------------------


def shard_act(x: torch.Tensor, names: Sequence[Optional[str]]) -> torch.Tensor:
    return x


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, stack: Tuple[int, ...] = ()) -> torch.Tensor:
    """Fan-in scaled normal init; optional leading stack dims.  Drawn on the
    generator's device."""
    return _normal(gen, (*stack, d_in, d_out), d_in ** -0.5, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """f32 statistics, output in x's dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * weight.float()).to(dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d_in) @ w: (d_in, d_out) in the compute dtype of x."""
    return torch.matmul(x, w.to(x.dtype))


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu" or kind == "silu":
        return F.silu(x)
    if kind == "geglu" or kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu(approximate=True)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# RoPE (split-halves layout)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                       # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activation compute dtype policy
# ---------------------------------------------------------------------------
# Parameters may be stored f32 while compute runs in another dtype: the cast
# happens once at the embedding; ``linear`` casts weights to the activation
# dtype per use.  ``None`` (the default) keeps the parameters' dtype.

_ACT_DTYPE: Optional[torch.dtype] = None


def set_act_dtype(dt: Optional[torch.dtype]) -> None:
    global _ACT_DTYPE
    _ACT_DTYPE = dt


def act_dtype_cast(x: torch.Tensor) -> torch.Tensor:
    if _ACT_DTYPE is not None and x.dtype != _ACT_DTYPE:
        return x.to(_ACT_DTYPE)
    return x


def layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
