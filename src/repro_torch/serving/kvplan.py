"""KV-cache capacity bound — the serving analog of Eq. 18.

Training's memory feasibility (``core.costmodel.memory_feasible``) bounds
``mem_p + K * mem_a`` per device; serving's bound is

    weights + sum_over_active_seqs(kv_footprint(seq)) <= headroom * pool_mem

where a sequence's footprint has a *growing* part (attention KV: bytes per
cached token, matching the ``models.*.init_cache`` array shapes byte for
byte for the dense/MoE families) and a *fixed* part (Mamba-2 SSM state and
conv tail in f32; VLM image-memory KV; audio encoder-memory KV).

Accounting is **paged** (vLLM-style): KV is reserved in blocks of
``block_tokens`` tokens, so the capacity constraint is an integer block
budget per pool and a request's reservation is block-rounded.  Admission
control reserves a request's *worst-case* blocks (prompt + full output)
before its first decode step — conservative, so the simulator can assert
the bound is never violated rather than model preemption.

Windowed attention layers (``sliding_window`` / ``local_global_ratio``) are
charged at the full-attention rate: a capacity bound may over-reserve but
must never under-reserve, and the planner has no per-layer eviction model.

Units: bytes, tokens.  No jax imports.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cluster import SubCluster


def _n_attn_layers(cfg: ArchConfig) -> int:
    """Layers that append per-token KV during decode."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        # zamba2: the shared transformer block runs every k SSM layers and
        # each application keeps its own KV
        return cfg.n_layers // cfg.shared_attn_every \
            if cfg.shared_attn_every else 0
    if cfg.family == "vlm" and cfg.cross_attn_every:
        # every cross_attn_every-th layer is cross-attention (image memory,
        # a fixed cost in state_bytes_per_seq) — it REPLACES the self-attn
        # layer, so it appends no per-token KV
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers


def kv_bytes_per_token(cfg: ArchConfig, dtype_bytes: float = 2.0) -> float:
    """Attention KV bytes appended per cached token: K and V heads across
    every KV-bearing layer.  Matches the dense/MoE decode caches
    (``(n_layers, B, S, n_kv_heads, head_dim)`` x2) exactly."""
    return _n_attn_layers(cfg) * 2.0 * cfg.kv_dim * dtype_bytes


def state_bytes_per_seq(cfg: ArchConfig, dtype_bytes: float = 2.0) -> float:
    """Fixed (seq-length-independent) per-sequence state bytes.

    - Mamba-2 SSD state: per layer, f32 ``(n_heads, head_dim, d_state)``
      state plus the ``(d_conv - 1, d_inner + 2*d_state)`` conv tail
      (``models.ssm.ssm_init_state`` shapes);
    - VLM cross-attention image-memory KV (``n_image_tokens`` per cross
      layer) and audio encoder-memory KV (``enc_frames`` per decoder
      layer), both at the cache dtype.
    """
    total = 0.0
    if cfg.ssm_state and cfg.family in ("ssm", "hybrid"):
        per_layer = (cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                     + (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state))
        total += cfg.n_layers * 4.0 * per_layer       # f32 state
    if cfg.family == "vlm" and cfg.cross_attn_every:
        n_cross = cfg.n_layers // cfg.cross_attn_every
        total += n_cross * 2.0 * cfg.kv_dim * dtype_bytes * cfg.n_image_tokens
    if cfg.enc_layers:
        total += cfg.n_layers * 2.0 * cfg.kv_dim * dtype_bytes * cfg.enc_frames
    return total


def kv_cache_bytes(cfg: ArchConfig, seq_len: int,
                   dtype_bytes: float = 2.0) -> float:
    """Un-paged per-sequence footprint at context ``seq_len`` (what a
    prefill→decode handoff actually ships)."""
    return seq_len * kv_bytes_per_token(cfg, dtype_bytes) \
        + state_bytes_per_seq(cfg, dtype_bytes)


@dataclass(frozen=True)
class KVBound:
    """One pool's paged KV budget: ``blocks_capacity`` blocks of
    ``block_bytes`` each, after weights and headroom."""
    block_bytes: float
    blocks_capacity: int

    def fits(self, used_blocks: int, new_blocks: int) -> bool:
        return used_blocks + new_blocks <= self.blocks_capacity


def block_bytes(cfg: ArchConfig, block_tokens: int,
                dtype_bytes: float = 2.0) -> float:
    """Bytes of one paged block.  KV-bearing families: ``block_tokens``
    tokens of KV.  Attention-free (pure SSM): the block *is* one sequence's
    fixed state — paging degenerates to per-sequence slots."""
    per_tok = kv_bytes_per_token(cfg, dtype_bytes)
    if per_tok > 0:
        return block_tokens * per_tok
    return max(state_bytes_per_seq(cfg, dtype_bytes), 1.0)


def blocks_for_seq(cfg: ArchConfig, seq_tokens: int, block_tokens: int,
                   dtype_bytes: float = 2.0) -> int:
    """Blocks a sequence with ``seq_tokens`` of context reserves: its KV
    block-rounded, plus whole blocks covering the fixed state."""
    bb = block_bytes(cfg, block_tokens, dtype_bytes)
    per_tok = kv_bytes_per_token(cfg, dtype_bytes)
    if per_tok <= 0:
        return 1
    kv_blocks = math.ceil(seq_tokens / block_tokens)
    state = state_bytes_per_seq(cfg, dtype_bytes)
    return kv_blocks + (math.ceil(state / bb) if state > 0 else 0)


def decode_capacity(cfg: ArchConfig, sub: SubCluster, *, weights_bytes: float,
                    block_tokens: int, dtype_bytes: float = 2.0,
                    mem_headroom: float = 0.9) -> KVBound:
    """The pool's Eq.-18-analog budget: blocks that fit in
    ``headroom * pool_mem - weights`` (0 when the weights alone don't fit —
    the placement search drops such pools as decode-infeasible)."""
    bb = block_bytes(cfg, block_tokens, dtype_bytes)
    free = mem_headroom * sub.n_devices * sub.device.mem_bytes - weights_bytes
    return KVBound(block_bytes=bb,
                   blocks_capacity=max(0, int(free // bb)))
