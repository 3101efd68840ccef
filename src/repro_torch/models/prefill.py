"""Prefill: full-sequence forward that RETURNS the serving state.

Counterpart of ``repro/models/prefill.py``, dense and SSM families.
``prefill(cfg, params, batch, cache_len=None)`` -> (last_logits (B,1,V),
cache), the cache in the family's ``init_cache`` layout, ready for
``decode_step``.  Each layer's K/V (dense, cast to the cache dtype as it
lands) or final SSD state and conv tail (SSM, f32) is written straight into
a preallocated cache, where the reference stacks every layer's output of
the scan: that saves a full-precision copy of the whole cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import attention as attn
from repro_torch.models import mamba_lm, transformer
from repro_torch.models.common import layer, rms_norm
from repro_torch.models.ssm import ssm_block

Params = Dict[str, Any]

# families whose prefill waits for a later slice, with the ROADMAP item
NOT_PORTED = {
    "moe": "ROADMAP.md Queue 1 item 7 (MoE)",
    "hybrid": "ROADMAP.md Queue 1 item 8 (hybrid, VLM, audio)",
    "vlm": "ROADMAP.md Queue 1 item 8 (hybrid, VLM, audio)",
    "audio": "ROADMAP.md Queue 1 item 8 (hybrid, VLM, audio)",
}


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILY:
        where = NOT_PORTED.get(cfg.family, "ROADMAP.md")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported yet: {where}")


def _attn_collect(cfg, p, h, *, window=0, use_kernels=False):
    a, (k, v) = attn.self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window,
        use_kernels=use_kernels, return_kv=True)
    return h + a, k, v


def _pad_cache(dst: torch.Tensor, k: torch.Tensor) -> None:
    """Write k (B, T, KV, D) into dst (B, cache_len, KV, D) at [:, :T]; the
    slots past T stay zero (the reference's right padding)."""
    dst[:, :k.shape[1]] = k


def _ring_slice(dst: torch.Tensor, k: torch.Tensor, T: int) -> None:
    """Write the last ``loc_len = dst.shape[1]`` positions of k into dst in
    decode's ring order (slot = position % loc_len)."""
    loc_len = dst.shape[1]
    w = min(loc_len, T)
    slots = torch.arange(T - w, T, device=k.device) % loc_len
    dst[:, slots] = k[:, T - w:].to(dst.dtype)


def _mlp_res(cfg, p, h):
    return h + mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                           cfg.activation)


def _prefill_dense(cfg, params, batch, cache_len, dtype, use_kernels):
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    B, T = h.shape[:2]
    cache = transformer.init_cache(cfg, B, cache_len, dtype, device=h.device)
    for i, window in transformer.layer_windows(cfg):
        p = layer(params["blocks"], i)
        h, k, v = _attn_collect(cfg, p, h, window=window, use_kernels=use_kernels)
        h = _mlp_res(cfg, p, h)
        ck, cv = transformer.layer_cache(cfg, cache, i)
        if ck.shape[1] == cache_len:
            _pad_cache(ck, k)
            _pad_cache(cv, v)
        else:                      # a sliding-window layer's ring buffer
            _ring_slice(ck, k, T)
            _ring_slice(cv, v, T)
    return transformer.lm_head(cfg, params, h[:, -1:]), cache


def _ssm_block_state(cfg, p, h, use_kernels):
    out, st = ssm_block(
        p["ssm"], rms_norm(h, p["ln"], cfg.norm_eps),
        d_inner=cfg.d_inner, d_state=cfg.ssm_state, n_heads=cfg.n_ssm_heads,
        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
        use_kernels=use_kernels, norm_eps=cfg.norm_eps, return_state=True)
    return h + out, st


def _prefill_ssm(cfg, params, batch, cache_len, dtype, use_kernels):
    """States ``{"s": (L,B,H,P,N), "conv": (L,B,K-1,C)}``, f32 whatever the
    cache dtype (the reference's are the scan's f32 outputs)."""
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    states = mamba_lm.init_cache(cfg, h.shape[0], cache_len, device=h.device)
    for i in range(cfg.n_layers):
        h, st = _ssm_block_state(cfg, layer(params["blocks"], i), h, use_kernels)
        for k, v in st.items():
            states[k][i] = v
    return transformer.lm_head(cfg, params, h[:, -1:]), states


_FAMILY = {"dense": _prefill_dense, "ssm": _prefill_ssm}


def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            cache_len: Optional[int] = None, cache_dtype=torch.bfloat16,
            use_kernels: bool = False) -> Tuple[torch.Tensor, Any]:
    check_family(cfg)
    T = batch["tokens"].shape[1]
    cache_len = cache_len or T
    if cache_len < T:
        raise ValueError(f"cache_len {cache_len} < prompt length {T}")
    return _FAMILY[cfg.family](cfg, params, batch, cache_len, cache_dtype,
                               use_kernels)
