"""Shared functional building blocks: norms, linears, embeddings, RoPE and
the activation dtype policy.

Counterpart of ``repro/models/common.py``.  Models are plain functions over
explicit parameter dicts of tensors; repeated blocks store parameters
stacked along a leading layer axis, as in the reference, and the forward
pass loops over that axis.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

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
    """Layer ``i`` of a stacked parameter (or cache) tree: views, no copies.
    For the serving path, which runs no backward; see :func:`unstack`."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` layers of a stacked tree, from one ``torch.unbind`` per leaf.

    Under autograd this matters: indexing a stacked leaf once per layer
    (:func:`layer`) gives each layer a backward that allocates a zero tensor
    of the whole stacked leaf, while one unbind has a single stacking
    backward for all layers."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level cross entropy with f32 statistics.

    logits: (..., V); labels: (...,) int.  Returns (loss, correct@1), both
    f32: ``loss = lse - logit[label]`` (plus ``z_loss * lse**2``), and the
    argmax with the first index winning ties."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0].float()
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    acc = (torch.argmax(logits, dim=-1) == labels).float()
    return loss, acc
