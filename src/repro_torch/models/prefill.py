"""Prefill: full-sequence forward that RETURNS the serving state.

Counterpart of ``repro/models/prefill.py``, every family: dense, MoE, SSM,
hybrid, VLM and audio.  ``prefill(cfg, params, batch, cache_len=None)`` ->
(last_logits (B,1,V), cache), the cache in the family's ``init_cache``
layout, ready for ``decode_step``.  Each layer's K/V (dense, MoE, the
hybrid's shared block, the VLM's self blocks and the audio decoder's,
cast to the cache dtype as it lands), each cross layer's K/V of the memory
(VLM and audio, the same) or final SSD state and conv tail (SSM and the
hybrid's SSD layers, f32) is written straight into a preallocated cache,
where the reference stacks every layer's output of the scan: that saves a
full-precision copy of the whole cache.  The VLM's batch also holds
``image_embeds`` (B, n_image_tokens, d), the audio family's ``frames`` (B,
enc_frames, d).

Under sharded execution (DTensor params, ``prefill_act_rules``) the cache
is made as DTensors in the decode layout (``sharding.cache_pspecs``:
batch, K/V sequence over ``model``), the layout the reference's
``shard_act`` sites give its stacked K/V, each rank allocating only its
shard; each layer's K/V is written where the cache lies
(``attention.write_rows``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import attention as attn
from repro_torch.models import (
    encdec, hybrid_lm, mamba_lm, moe_lm, transformer, vlm,
)
from repro_torch.models.common import (
    current_mesh, current_rules, layer, rms_norm, shard_act,
)
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import ssm_block

Params = Dict[str, Any]


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch_id}) is not ported")


def _attn_collect(cfg, p, h, *, window=0, use_kernels=False):
    a, (k, v) = attn.self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window,
        use_kernels=use_kernels, return_kv=True)
    return h + a, k, v


def _new_cache(init, cfg, batch: int, cache_len: int, *args, device):
    """The family's zeroed cache (``init(cfg, batch, cache_len, *args,
    device=...)``); under an ambient mesh and rules, DTensors placed by
    ``cache_pspecs``, each rank allocating only its shard."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return init(cfg, batch, cache_len, *args, device=device)
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.optimizer import tree_map

    meta = init(cfg, batch, cache_len, *args, device="meta")
    shardings = shd.fitted_shardings(mesh, shd.cache_pspecs(meta, rules), meta)
    return tree_map(lambda sh, x: sh.place(x, device).zero_(), shardings, meta)


def _pad_cache(dst: torch.Tensor, k: torch.Tensor) -> None:
    """Write k (B, T, KV, D) into dst (B, cache_len, KV, D) at [:, :T]; the
    slots past T stay zero (the reference's right padding)."""
    attn.write_rows(dst, k)


def _ring_slice(dst: torch.Tensor, k: torch.Tensor, T: int) -> None:
    """Write the last ``loc_len = dst.shape[1]`` positions of k into dst in
    decode's ring order (slot = position % loc_len): a rotation of the
    tail when it fills the ring, the first T slots when it does not."""
    loc_len = dst.shape[1]
    w = min(loc_len, T)
    tail = k[:, T - w:]
    if w == loc_len:                  # position T - w + j lands in slot (T - w + j) % L
        s = (T - w) % loc_len
        tail = torch.cat([tail[:, loc_len - s:], tail[:, :loc_len - s]], dim=1)
    attn.write_rows(dst, tail)


def _mlp_res(cfg, p, h):
    return h + mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                           cfg.activation)


def _prefill_dense(cfg, params, batch, cache_len, dtype, use_kernels):
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    B, T = h.shape[:2]
    cache = _new_cache(transformer.init_cache, cfg, B, cache_len, dtype, device=h.device)
    for i, window in transformer.layer_windows(cfg):
        p = layer(params["blocks"], i)
        h, k, v = _attn_collect(cfg, p, h, window=window, use_kernels=use_kernels)
        h = shard_act(_mlp_res(cfg, p, h), ("batch", "seq", "embed"))
        ck, cv = transformer.layer_cache(cfg, cache, i)
        if ck.shape[1] == cache_len:
            _pad_cache(ck, k)
            _pad_cache(cv, v)
        else:                      # a sliding-window layer's ring buffer
            _ring_slice(ck, k, T)
            _ring_slice(cv, v, T)
    return transformer.lm_head(cfg, params, h[:, -1:]), cache


def _prefill_moe(cfg, params, batch, cache_len, dtype, use_kernels):
    """Routing capacity is taken over the B * T prompt tokens; the layers'
    aux losses are not computed."""
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    cache = _new_cache(moe_lm.init_cache, cfg, h.shape[0], cache_len, dtype,
                       device=h.device)
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        h, k, v = _attn_collect(cfg, p, h, use_kernels=use_kernels)
        m, _ = moe_block(p["moe"], rms_norm(h, p["ln2"], cfg.norm_eps),
                         top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                         activation=cfg.activation, router_aux_coef=0.0)
        h = h + m
        _pad_cache(cache["k"][i], k)
        _pad_cache(cache["v"][i], v)
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
    states = _new_cache(mamba_lm.init_cache, cfg, h.shape[0], cache_len,
                        device=h.device)
    for i in range(cfg.n_layers):
        h, st = _ssm_block_state(cfg, layer(params["blocks"], i), h, use_kernels)
        for k, v in st.items():
            states[k][i] = v
    return transformer.lm_head(cfg, params, h[:, -1:]), states


def _write_state(dst: Dict[str, torch.Tensor], st: Dict[str, torch.Tensor]) -> None:
    for k, v in st.items():
        dst[k].copy_(v)


def _prefill_hybrid(cfg, params, batch, cache_len, dtype, use_kernels):
    """SSD states f32 (``ssm_groups`` (n_apps, k, B, ...), ``ssm_tail``);
    each shared application's K/V in the cache dtype (n_apps, B, S, KV, D)."""
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    cache = _new_cache(hybrid_lm.init_cache, cfg, h.shape[0], cache_len, dtype,
                       device=h.device)
    for g in range(hybrid_lm._n_apps(cfg)):
        pg, st_g = layer(params["groups"], g), layer(cache["ssm_groups"], g)
        for j in range(cfg.shared_attn_every):
            h, st = _ssm_block_state(cfg, layer(pg, j), h, use_kernels)
            _write_state(layer(st_g, j), st)
        h, (k, v) = hybrid_lm._shared_apply(
            cfg, params["shared"], params["adapt_in"][g], params["adapt_out"][g],
            h, use_kernels, return_kv=True)
        _pad_cache(cache["k"][g], k)
        _pad_cache(cache["v"][g], v)
    for i in range(hybrid_lm._n_tail(cfg)):
        h, st = _ssm_block_state(cfg, layer(params["tail"], i), h, use_kernels)
        _write_state(layer(cache["ssm_tail"], i), st)
    return transformer.lm_head(cfg, params, h[:, -1:]), cache


def _prefill_vlm(cfg, params, batch, cache_len, dtype, use_kernels):
    """The self blocks' K/V (n_groups, n_self, B, S, KV, D) and each cross
    block's memory K/V (n_groups, B, n_image_tokens, KV, D), in the cache
    dtype."""
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    memory = batch["image_embeds"].to(h.dtype)
    cache = _new_cache(vlm.init_cache, cfg, h.shape[0], cache_len, dtype,
                       device=h.device)
    n_groups, n_self = vlm._group_dims(cfg)
    for g in range(n_groups):
        pg_self = layer(params["self_blocks"], g)
        for j in range(n_self):
            p = layer(pg_self, j)
            h, k, v = _attn_collect(cfg, p, h, use_kernels=use_kernels)
            h = _mlp_res(cfg, p, h)
            _pad_cache(cache["k"][g, j], k)
            _pad_cache(cache["v"][g, j], v)
        h, (mk, mv) = vlm._cross_apply(cfg, layer(params["cross_blocks"], g), h,
                                       memory, use_kernels=use_kernels,
                                       return_kv=True)
        cache["mem_k"][g] = mk
        cache["mem_v"][g] = mv
    return transformer.lm_head(cfg, params, h[:, -1:]), cache


def _prefill_audio(cfg, params, batch, cache_len, dtype, use_kernels):
    """The decoder's self-attention K/V (L, B, S, KV, D) and each layer's
    memory K/V (L, B, enc_frames, KV, D), in the cache dtype."""
    memory = encdec.encode(cfg, params,
                           batch["frames"].to(params["embed"].dtype),
                           use_kernels=use_kernels, remat=False)
    h = encdec.embed_positions(params, batch["tokens"])
    cache = _new_cache(encdec.init_cache, cfg, h.shape[0], cache_len, dtype,
                       device=h.device)
    for i in range(cfg.n_layers):
        h, (k, v), (mk, mv) = encdec._dec_block(
            cfg, layer(params["dec_blocks"], i), h, memory, use_kernels,
            return_kv=True)
        _pad_cache(cache["k"][i], k)
        _pad_cache(cache["v"][i], v)
        cache["mem_k"][i] = mk
        cache["mem_v"][i] = mv
    return transformer.lm_head(cfg, params, h[:, -1:]), cache


_FAMILY = {"dense": _prefill_dense, "moe": _prefill_moe, "ssm": _prefill_ssm,
           "hybrid": _prefill_hybrid, "vlm": _prefill_vlm,
           "audio": _prefill_audio}


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
