"""Plain PyTorch versions of the port's kernels (the ground truth for tests).

Each follows its kernel's contract exactly, which for flash attention is not
``models.attention.attention_ref``'s: masked scores are ``-inf`` (not a
finite ``-2**30``), and a row with every key masked gets a zero output and
``lse = -inf``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: q (B, T, H, D); k, v (B, S, KV, D).

    Returns (out (B, T, H, D) in q's dtype, lse (B, H, T) float32)."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (D ** -0.5)
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m == float("-inf"), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")),
                      m_safe + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse
