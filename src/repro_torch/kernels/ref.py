"""Plain PyTorch versions of the port's kernels (the ground truth for tests).

Each follows its kernel's contract exactly, which for flash attention is not
``models.attention.attention_ref``'s: masked scores are ``-inf`` (not a
finite ``-2**30``), and a row with every key masked gets a zero output and
``lse = -inf``.  The SSD intra-chunk term's is ``models.ssm.ssd_intra_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.ssm import ssd_intra_ref


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


def _bwd_probs(q, k, v, lse, do, delta, causal, window):
    """(P, dS, K, Q, dO) of the backward, f32, heads expanded: P (B,H,T,S)
    is ``exp(scale * q.k - lse)`` on unmasked pairs of rows with a finite
    lse and 0 elsewhere; ``dS = P * (do.v - delta) * scale``."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = D ** -0.5
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    live = torch.isfinite(lse)[..., None]
    lse_safe = torch.where(live[..., 0], lse, torch.zeros_like(lse))
    p = torch.where(mask & live, torch.exp(s - lse_safe[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, kf, qf, dof


def flash_attention_bwd_dq_ref(q, k, v, out, lse, do, *, causal: bool,
                               window: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel's contract: (dq (B, T, H, D) in q's dtype,
    delta = rowsum(do * out) (B, H, T) f32)."""
    delta = (do.float() * out.float()).sum(dim=-1).permute(0, 2, 1)
    _, ds, kf, _, _ = _bwd_probs(q, k, v, lse, do, delta, causal, window)
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype), delta


def flash_attention_bwd_dkv_ref(q, k, v, lse, do, delta, *, causal: bool,
                                window: int = 0
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's contract: (dk, dv) (B, S, KV, D) in k's and v's
    dtypes, summed over the query heads of each kv head."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    p, ds, _, qf, dof = _bwd_probs(q, k, v, lse, do, delta, causal, window)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, S, KV, H // KV, D).sum(dim=3)
    dv = dv.reshape(B, S, KV, H // KV, D).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, causal: bool, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`flash_attention_ref`, the contract of the two
    backward kernels.  Model layout: q, out, do (B, T, H, D); k, v
    (B, S, KV, D); lse (B, H, T) from the forward.

    ``delta = rowsum(do * out)`` in f32; ``P = exp(scale * q.k - lse)`` on
    unmasked pairs and 0 elsewhere, also on rows whose lse is ``-inf``;
    ``dS = P * (do.v - delta) * scale``.  Masks use the real lengths.
    Returns (dq, dk, dv) in the inputs' layouts and dtypes, dk and dv summed
    over the query heads of each kv head."""
    dq, delta = flash_attention_bwd_dq_ref(q, k, v, out, lse, do,
                                           causal=causal, window=window)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, lse, do, delta,
                                         causal=causal, window=window)
    return dq, dk, dv


def ssd_intra_oracle(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor) -> torch.Tensor:
    """Same contract as the SSD intra-chunk kernel K5 (f32 output)."""
    return ssd_intra_ref(xc, dtc, cum, Bc, Cc).float()
