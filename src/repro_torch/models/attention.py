"""Attention: GQA/MQA/MHA self-attention (full / sliding-window / causal),
and single-token decode against a KV cache.

Counterpart of ``repro/models/attention.py``.  The plain torch path here is
the reference implementation; the full-sequence path dispatches to the
Hopper flash kernel (``repro_torch.kernels.ops``) when ``use_kernels``.
Decode attention stays plain torch, as the reference's is jnp.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.common import apply_rope, dense_init, linear, shard_act

NEG_INF = -2.0 ** 30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, dtype=torch.float32,
              stack: Tuple[int, ...] = ()) -> Dict[str, Any]:
    q_dim, kv_dim = n_heads * head_dim, n_kv_heads * head_dim
    return {
        "wq": dense_init(gen, d_model, q_dim, dtype, stack),
        "wk": dense_init(gen, d_model, kv_dim, dtype, stack),
        "wv": dense_init(gen, d_model, kv_dim, dtype, stack),
        "wo": dense_init(gen, q_dim, d_model, dtype, stack),
    }


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """q head h uses kv head h // n_rep (``jnp.repeat``, not a tile)."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def _masked_softmax_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """f32 scores of q (B,Tq,H,D) against k, v (B,Tk,H,D); ``valid``
    broadcasts to (B,H,Tq,Tk); masked scores are the finite NEG_INF."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float())


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Plain attention oracle.

    q: (B, Tq, H, D); k, v: (B, Tk, KV, D). ``q_offset`` positions queries
    within the kv axis. ``window`` > 0 limits lookback (sliding window)."""
    B, Tq, H, D = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    q_pos = torch.arange(Tq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Tk, device=q.device)[None, :]
    valid = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window:
        valid = valid & (k_pos > q_pos - window)
    return _masked_softmax_attend(q, k, v, valid[None, None]).to(q.dtype)


CHUNK_THRESHOLD = 8192  # q-chunk the plain path beyond this (memory: O(T*chunk))


def attention_chunked(q, k, v, *, causal: bool, window: int,
                      chunk: int = 1024) -> torch.Tensor:
    """Memory-efficient plain attention: scores materialized per q-chunk."""
    outs = [attention_ref(q[:, s:s + chunk], k, v, causal=causal,
                          window=window, q_offset=s)
            for s in range(0, q.shape[1], chunk)]
    return torch.cat(outs, dim=1)


def _attention(q, k, v, *, causal: bool, window: int, use_kernels: bool):
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if q.shape[1] >= CHUNK_THRESHOLD and q.shape[1] == k.shape[1]:
        return attention_chunked(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def self_attention(p: Dict[str, Any], h: torch.Tensor, *,
                   n_heads: int, n_kv_heads: int, head_dim: int,
                   rope_theta: float, causal: bool = True, window: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   use_kernels: bool = False, return_kv: bool = False):
    """Full-sequence self attention (prefill)."""
    B, T, _ = h.shape
    q = _split_heads(linear(h, p["wq"]), n_heads, head_dim)
    k = _split_heads(linear(h, p["wk"]), n_kv_heads, head_dim)
    v = _split_heads(linear(h, p["wv"]), n_kv_heads, head_dim)
    if rope_theta:
        pos = torch.arange(T, device=h.device) if positions is None else positions
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    q = shard_act(q, ("batch", "seq", "heads", None))
    k = shard_act(k, ("batch", "seq", "kv_heads", None))
    v = shard_act(v, ("batch", "seq", "kv_heads", None))
    out = _attention(q, k, v, causal=causal, window=window, use_kernels=use_kernels)
    out = linear(out.reshape(B, T, -1), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# Decode (single new token against a KV cache)
# ---------------------------------------------------------------------------


def decode_self_attention(p: Dict[str, Any], h: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          pos: int, *, n_heads: int, n_kv_heads: int,
                          head_dim: int, rope_theta: float, window: int = 0):
    """h: (B, 1, d); cache_k/v: (B, S, KV, D); pos: index of the new token.

    Returns (out, (cache_k, cache_v)).  The new KV is written at ``pos``
    (ring-buffered modulo S for sliding windows) IN PLACE: the returned
    cache tensors are the ones passed in, which saves a copy of the whole
    cache per step."""
    B = h.shape[0]
    S = cache_k.shape[1]
    q = _split_heads(linear(h, p["wq"]), n_heads, head_dim)
    k_new = _split_heads(linear(h, p["wk"]), n_kv_heads, head_dim)
    v_new = _split_heads(linear(h, p["wv"]), n_kv_heads, head_dim)
    if rope_theta:
        pvec = torch.full((1,), pos, dtype=torch.int64, device=h.device)
        q = apply_rope(q, pvec, rope_theta)
        k_new = apply_rope(k_new, pvec, rope_theta)
    slot = pos % S if window else min(pos, S - 1)     # Python %: floor modulo
    cache_k[:, slot] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v_new[:, 0].to(cache_v.dtype)
    k = _repeat_kv(cache_k, n_heads // n_kv_heads)
    v = _repeat_kv(cache_v, n_heads // n_kv_heads)
    k_idx = torch.arange(S, device=h.device)
    if window:
        # ring buffer: valid slots are the last min(pos+1, window) writes
        age = torch.remainder(pos - k_idx, S)              # steps since write
        valid = (age < window) if pos >= S else (k_idx <= pos) & (age < window)
    else:
        valid = k_idx <= min(pos, S - 1)
    out = _masked_softmax_attend(q, k, v, valid[None, None, None, :]).to(h.dtype)
    out = linear(out.reshape(B, 1, -1), p["wo"])
    return out, (cache_k, cache_v)


def init_kv_cache(batch: int, seq_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, window: int = 0,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window layers only need ``window`` slots (ring buffer)."""
    S = min(seq_len, window) if window else seq_len
    shape = (batch, S, n_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
