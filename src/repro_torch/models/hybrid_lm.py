"""Zamba2-style hybrid LM: a Mamba-2 backbone plus one *shared* transformer
block applied every ``shared_attn_every`` SSD layers through
per-application adapters (zamba2-7b).

Counterpart of ``repro/models/hybrid_lm.py``.  zamba2-7b: 81 SSD layers,
the shared block after layers 6, 12, ..., 78 (13 applications), then a
3-layer tail.  The parameter tree is the reference's: SSD blocks stacked
``groups`` (n_apps, k, ...) and ``tail`` (n_tail, ...), ``adapt_in`` /
``adapt_out`` (n_apps, d, d), one ``shared`` block.  The reference's scans
are Python loops over those axes.  ``forward(..., remat=True)`` recomputes
one group (its k SSD blocks and the shared application) at a time in the
backward, as the reference's ``jax.checkpoint(group_body)`` does, and each
tail block on its own.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba_lm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import (
    dense_init, embed_init, layer, linear, rms_norm, unstack,
)
from repro_torch.models.ssm import ssm_decode_step, ssm_init_state

Params = Dict[str, Any]


def _n_apps(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def _n_tail(cfg: ArchConfig) -> int:
    return cfg.n_layers - _n_apps(cfg) * cfg.shared_attn_every


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Parameters on the generator's device, in the reference's tree."""
    n_apps, k, d = _n_apps(cfg), cfg.shared_attn_every, cfg.d_model
    dev = gen.device
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype),
        "groups": mamba_lm.block_init(cfg, gen, dtype, stack=(n_apps, k)),
        "tail": mamba_lm.block_init(cfg, gen, dtype, stack=(_n_tail(cfg),)),
        "shared": {
            "ln1": torch.ones((d,), dtype=dtype, device=dev),
            "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.head_dim, dtype),
            "ln2": torch.ones((d,), dtype=dtype, device=dev),
            "mlp": mlp_mod.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype),
        },
        "adapt_in": dense_init(gen, d, d, dtype, (n_apps,)),
        "adapt_out": dense_init(gen, d, d, dtype, (n_apps,)),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype)
    return p


def _shared_apply(cfg: ArchConfig, shared: Params, a_in: torch.Tensor,
                  a_out: torch.Tensor, h: torch.Tensor, use_kernels: bool,
                  return_kv: bool = False):
    """One application of the shared block: h + adapt_out(block(adapt_in(h))).
    ``return_kv`` also returns the attention's (k, v) (B, T, KV, D), for
    prefill."""
    x = linear(h, a_in)
    y = attn.self_attention(
        shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, use_kernels=use_kernels,
        return_kv=return_kv)
    if return_kv:
        y, kv = y
    x = x + y
    x = x + mlp_mod.mlp(shared["mlp"], rms_norm(x, shared["ln2"], cfg.norm_eps),
                        cfg.activation)
    h = h + linear(x, a_out)
    return (h, kv) if return_kv else h


def _group_apply(cfg: ArchConfig, pg: Params, shared: Params, a_in: torch.Tensor,
                 a_out: torch.Tensor, h: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    """A group's k SSD blocks, then the shared block's application."""
    for p in unstack(pg, cfg.shared_attn_every):
        h = mamba_lm._block_apply(cfg, p, h, use_kernels)
    return _shared_apply(cfg, shared, a_in, a_out, h, use_kernels)


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = True):
    """-> (logits (B,T,V), aux_loss scalar 0).  Groups and tail layers come
    from one unbind per stacked leaf (``unstack``) at each level; the
    shared block's gradient sums its applications through autograd."""
    h = tf.embed_tokens(cfg, params, batch["tokens"])
    n_apps = _n_apps(cfg)
    groups = zip(unstack(params["groups"], n_apps),
                 unstack(params["adapt_in"], n_apps),
                 unstack(params["adapt_out"], n_apps))
    for pg, a_in, a_out in groups:
        args = (cfg, pg, params["shared"], a_in, a_out, h, use_kernels)
        h = (checkpoint(_group_apply, *args, use_reentrant=False) if remat
             else _group_apply(*args))
    for p in unstack(params["tail"], _n_tail(cfg)):
        if remat:
            h = checkpoint(mamba_lm._block_apply, cfg, p, h, use_kernels,
                           use_reentrant=False)
        else:
            h = mamba_lm._block_apply(cfg, p, h, use_kernels)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return tf.lm_head(cfg, params, h), aux


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """Zeroed decode state: ``ssm_groups`` {"s", "conv"} (n_apps, k, B, ...)
    and ``ssm_tail`` (n_tail, B, ...), f32 whatever ``dtype``; the shared
    block's KV cache ``k`` / ``v`` (n_apps, B, S, KV, D) in ``dtype``."""
    n_apps, k = _n_apps(cfg), cfg.shared_attn_every
    single = ssm_init_state(batch, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_conv, device=device)

    def stacked(*lead):
        return {name: torch.zeros((*lead, *x.shape), dtype=x.dtype, device=device)
                for name, x in single.items()}
    kv_shape = (n_apps, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"ssm_groups": stacked(n_apps, k), "ssm_tail": stacked(_n_tail(cfg)),
            "k": torch.zeros(kv_shape, dtype=dtype, device=device),
            "v": torch.zeros(kv_shape, dtype=dtype, device=device)}


def _ssm_step(cfg: ArchConfig, p: Params, h: torch.Tensor,
              state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One SSD block's decode step; ``state`` (views into the cache) is
    overwritten with the new state."""
    out, st = ssm_decode_step(
        p["ssm"], rms_norm(h, p["ln"], cfg.norm_eps), state,
        d_inner=cfg.d_inner, d_state=cfg.ssm_state, n_heads=cfg.n_ssm_heads,
        head_dim=cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
    for name, v in st.items():
        state[name].copy_(v)
    return h + out


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; pos: next position index (the shared block's KV
    slot; the SSD steps are position-free).

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    h = tf.embed_tokens(cfg, params, tokens)
    shared = params["shared"]
    for g in range(_n_apps(cfg)):
        pg, st_g = layer(params["groups"], g), layer(cache["ssm_groups"], g)
        for j in range(cfg.shared_attn_every):
            h = _ssm_step(cfg, layer(pg, j), h, layer(st_g, j))
        x = linear(h, params["adapt_in"][g])
        y, _ = attn.decode_self_attention(
            shared["attn"], rms_norm(x, shared["ln1"], cfg.norm_eps),
            cache["k"][g], cache["v"][g], pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta)
        x = x + y
        x = x + mlp_mod.mlp(shared["mlp"], rms_norm(x, shared["ln2"], cfg.norm_eps),
                            cfg.activation)
        h = h + linear(x, params["adapt_out"][g])
    for i in range(_n_tail(cfg)):
        h = _ssm_step(cfg, layer(params["tail"], i), h,
                      layer(cache["ssm_tail"], i))
    return tf.lm_head(cfg, params, h), cache
