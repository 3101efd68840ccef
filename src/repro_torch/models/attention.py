"""Attention: GQA/MQA/MHA self-attention (full / sliding-window / causal /
bidirectional), cross-attention, and single-token decode against a KV cache.

Counterpart of ``repro/models/attention.py``.  The plain torch path here is
the reference implementation; the full-sequence paths (self and cross
attention) dispatch to the Hopper flash kernel (``repro_torch.kernels.ops``)
when ``use_kernels``.  Decode attention stays plain torch, as the
reference's is jnp.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import (
    apply_rope, dense_init, linear, local_shards, merge_last, on_mesh,
    replicate_dims, shard_act, shard_index, shards_of, split_last,
)

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
    return split_last(x, n_heads, head_dim)


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


def _plain_attention(q, k, v, *, causal: bool, window: int):
    if q.shape[1] >= CHUNK_THRESHOLD and q.shape[1] == k.shape[1]:
        return attention_chunked(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window)


def _attention(q, k, v, *, causal: bool, window: int, use_kernels: bool):
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, causal=causal, window=window)
    return _plain_attention(q, k, v, causal=causal, window=window)


def _sharded_attention(q, k, v, *, causal: bool, window: int):
    """The plain attention of DTensors, one shard of (batch, heads) per
    rank (``local_map``): attention is independent per sequence and per
    head, so each rank runs :func:`_plain_attention` on its own q heads
    and the K/V heads they read.  q keeps its batch and head sharding
    (sequence and head dim whole); K/V follow q's batch sharding and shard
    their heads the same way where the K/V head count splits as q's does,
    else stay whole over those mesh dims, and each rank picks the K/V head
    of each of its q heads (``h // n_rep``, as ``_repeat_kv``).  Where K/V
    are whole but q is split, each rank's K/V gradient covers only its
    heads: the gradient is ``Partial`` there."""
    mesh = q.device_mesh
    q = replicate_dims(q, [1, 3])
    H, KV = q.shape[2], k.shape[2]
    n_rep = H // KV
    h_split = shards_of(q, 2)
    kv_split = h_split if KV % h_split == 0 else 1
    kv_pl, kv_grad = [], []
    for p in q.placements:
        if p == Shard(0):
            kv_pl.append(Shard(0))
            kv_grad.append(Shard(0))
        elif p == Shard(2) and kv_split > 1:
            kv_pl.append(Shard(2))
            kv_grad.append(Shard(2))
        else:
            kv_pl.append(Replicate())
            kv_grad.append(Partial() if p == Shard(2) else Replicate())
    k = k.redistribute(mesh, kv_pl) if isinstance(k, DTensor) else k
    v = v.redistribute(mesh, kv_pl) if isinstance(v, DTensor) else v
    h_local = H // h_split
    h_lo = shard_index(mesh, q.placements, 2) * h_local
    kv_lo = h_lo // n_rep if kv_split > 1 else 0

    def local(ql, kl, vl):
        if n_rep > 1 or kl.shape[2] != h_local:
            idx = torch.arange(h_lo, h_lo + h_local, device=ql.device) // n_rep - kv_lo
            kl = kl.index_select(2, idx)
            vl = vl.index_select(2, idx)
        return _plain_attention(ql, kl, vl, causal=causal, window=window)

    return local_map(local_shards(local), out_placements=list(q.placements),
                     in_placements=(q.placements, kv_pl, kv_pl),
                     in_grad_placements=(q.placements, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def self_attention(p: Dict[str, Any], h: torch.Tensor, *,
                   n_heads: int, n_kv_heads: int, head_dim: int,
                   rope_theta: float, causal: bool = True, window: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   use_kernels: bool = False, return_kv: bool = False):
    """Full-sequence self attention (train / prefill)."""
    T = h.shape[1]
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
    out = linear(merge_last(out), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def cross_kv(p: Dict[str, Any], memory: torch.Tensor, *, n_kv_heads: int,
             head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A cross-attention block's K, V (B, M, KV, D) of the memory (B, M, d)."""
    return (_split_heads(linear(memory, p["wk"]), n_kv_heads, head_dim),
            _split_heads(linear(memory, p["wv"]), n_kv_heads, head_dim))


def cross_attention(p: Dict[str, Any], h: torch.Tensor, memory: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    use_kernels: bool = False,
                    memory_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    return_kv: bool = False):
    """Cross attention of h (B, T, d) over an encoder / image memory (B, M,
    d), non-causal: T and M differ.  ``memory_kv`` (k, v) (B, M, KV, D)
    replaces the memory's projections; ``return_kv`` also returns them."""
    q = _split_heads(linear(h, p["wq"]), n_heads, head_dim)
    k, v = memory_kv if memory_kv is not None else cross_kv(
        p, memory, n_kv_heads=n_kv_heads, head_dim=head_dim)
    out = _attention(q, k, v, causal=False, window=0, use_kernels=use_kernels)
    out = linear(merge_last(out), p["wo"])
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
    cache per step.  A DTensor cache is written and read where it lies
    (:func:`write_rows`, :func:`_sharded_decode_attend`)."""
    S = cache_k.shape[1]
    q = _split_heads(linear(h, p["wq"]), n_heads, head_dim)
    k_new = _split_heads(linear(h, p["wk"]), n_kv_heads, head_dim)
    v_new = _split_heads(linear(h, p["wv"]), n_kv_heads, head_dim)
    if rope_theta:
        pvec = torch.full((1,), pos, dtype=torch.int64, device=h.device)
        q = apply_rope(q, pvec, rope_theta)
        k_new = apply_rope(k_new, pvec, rope_theta)
    slot = pos % S if window else min(pos, S - 1)     # Python %: floor modulo
    write_rows(cache_k, k_new, slot)
    write_rows(cache_v, v_new, slot)

    def valid_slots(k_idx):
        if window:
            # ring buffer: valid slots are the last min(pos+1, window) writes
            age = torch.remainder(pos - k_idx, S)          # steps since write
            return (age < window) if pos >= S else (k_idx <= pos) & (age < window)
        return k_idx <= min(pos, S - 1)

    n_rep = n_heads // n_kv_heads
    if isinstance(cache_k, DTensor):
        out = _sharded_decode_attend(q, cache_k, cache_v, n_rep, valid_slots)
    else:
        k = _repeat_kv(cache_k, n_rep)
        v = _repeat_kv(cache_v, n_rep)
        valid = valid_slots(torch.arange(S, device=h.device))
        out = _masked_softmax_attend(q, k, v, valid[None, None, None, :])
    out = linear(merge_last(out.to(h.dtype)), p["wo"])
    return out, (cache_k, cache_v)


def write_rows(cache: torch.Tensor, value: torch.Tensor, start: int = 0) -> None:
    """``cache[:, start:start + T] = value`` in place, in the cache's dtype
    (cache (B, S, ...), value (B, T, ...)).  A DTensor cache is written
    where it lies: each rank copies the part of ``value`` that falls in
    its own slots, ``value`` placed as the cache is on its other dims.  A
    slice or an index of a sharded dim would gather the cache and write
    into the copy."""
    if not isinstance(cache, DTensor):
        cache[:, start:start + value.shape[1]] = value.to(cache.dtype)
        return
    mesh = cache.device_mesh
    local = cache.to_local()
    if (isinstance(value, DTensor) and start == 0 and value.shape == cache.shape
            and tuple(value.placements) == tuple(cache.placements)):
        local.copy_(value.to_local())
        return
    pl = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p
          for p in cache.placements]
    value = on_mesh(value, mesh).redistribute(mesh, pl).to_local()
    lo = shard_index(mesh, cache.placements, 1) * local.shape[1]
    a = max(lo, start)
    b = min(lo + local.shape[1], start + value.shape[1])
    if a < b:
        local[:, a - lo:b - lo] = value[:, a - start:b - start].to(local.dtype)


def _sharded_decode_attend(q, cache_k, cache_v, n_rep: int, valid_slots):
    """One token's attention over a DTensor cache (B, S, KV, D) whose
    sequence may be sharded (``kv_seq`` over ``model``, or every axis at
    batch 1): each rank attends over its own slots, and the softmax is
    combined over the sequence's mesh dims in two passes, the max of the
    scores (``Partial`` max), then the sums of the exponentials and of the
    values they weight (``Partial`` sums): the distributed-decode layout.
    q is replicated but for its batch, split as the cache's.
    ``valid_slots`` maps global slot indices to the validity mask."""
    mesh = cache_k.device_mesh
    cp = cache_k.placements
    seq_dims = [i for i, p in enumerate(cp) if p == Shard(1)]
    q_pl = [Shard(0) if p == Shard(0) else Replicate() for p in cp]
    q = on_mesh(q, mesh).redistribute(mesh, q_pl)
    cache_v = cache_v.redistribute(mesh, cp)
    s_local = cache_k.to_local().shape[1]
    lo = shard_index(mesh, cp, 1) * s_local

    def over_seq(op):
        return [Partial(op) if i in seq_dims else p for i, p in enumerate(q_pl)]

    def scores(ql, kl):
        k = _repeat_kv(kl, n_rep)
        sc = torch.einsum("bqhd,bkhd->bhqk", ql.float(), k.float()) * ql.shape[-1] ** -0.5
        valid = valid_slots(torch.arange(lo, lo + s_local, device=ql.device))
        return torch.where(valid[None, None, None, :], sc, torch.full_like(sc, NEG_INF))

    def local_max(ql, kl):
        return scores(ql, kl).amax(dim=-1, keepdim=True)

    def local_sums(ql, kl, vl, ml):
        p = torch.exp(scores(ql, kl) - ml)
        o = torch.einsum("bhqk,bkhd->bqhd", p, _repeat_kv(vl, n_rep).float())
        return o, p.sum(dim=-1).transpose(1, 2)[..., None]

    m = local_map(local_max, out_placements=over_seq("max"),
                  in_placements=(q_pl, cp), device_mesh=mesh)(q, cache_k)
    m = m.redistribute(mesh, q_pl)
    o, l = local_map(local_sums, out_placements=(over_seq("sum"), over_seq("sum")),
                     in_placements=(q_pl, cp, cp, q_pl), device_mesh=mesh)(
                         q, cache_k, cache_v, m)
    return o.redistribute(mesh, q_pl) / l.redistribute(mesh, q_pl)


def decode_cross_attention(p: Dict[str, Any], h: torch.Tensor,
                           mem_k: torch.Tensor, mem_v: torch.Tensor, *,
                           n_heads: int, n_kv_heads: int, head_dim: int):
    """Decode-time cross attention of h (B, 1, d) over a precomputed memory
    K/V (B, M, KV, D), in any cache dtype: the scores and the weighted sum
    are f32 (``attention_ref``), the output in h's dtype."""
    q = _split_heads(linear(h, p["wq"]), n_heads, head_dim)
    if isinstance(mem_k, DTensor):          # the memory's rows may be sharded
        out = _sharded_decode_attend(q, mem_k, mem_v, n_heads // n_kv_heads,
                                     lambda k_idx: torch.ones_like(k_idx, dtype=torch.bool))
        out = out.to(h.dtype)
    else:
        out = attention_ref(q, mem_k, mem_v, causal=False)
    return linear(merge_last(out), p["wo"])


def init_kv_cache(batch: int, seq_len: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, window: int = 0,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sliding-window layers only need ``window`` slots (ring buffer)."""
    S = min(seq_len, window) if window else seq_len
    shape = (batch, S, n_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
