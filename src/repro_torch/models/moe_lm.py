"""Mixture-of-experts decoder LMs (qwen3-moe-235b-a22b, granite-moe-1b-a400m).

Counterpart of ``repro/models/moe_lm.py``.  Blocks are parameter-stacked
along a leading layer axis; the reference's ``lax.scan`` is a Python loop
over that axis.  ``forward`` sums every layer's router aux loss, as the
reference's scan carry does, and with ``remat=True`` recomputes each
block's activations in the backward, as its ``jax.checkpoint`` per block
does.  The KV cache is the dense family's (L, B, S, KV, D).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import dense_init, embed_init, layer, rms_norm, unstack
from repro_torch.models.moe import moe_block, moe_init

Params = Dict[str, Any]


def block_init(cfg: ArchConfig, gen: torch.Generator, dtype,
               stack: Tuple[int, ...] = ()) -> Params:
    dev = gen.device
    return {
        "ln1": torch.ones((*stack, cfg.d_model), dtype=dtype, device=dev),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, dtype, stack=stack),
        "ln2": torch.ones((*stack, cfg.d_model), dtype=dtype, device=dev),
        "moe": moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                        cfg.activation, dtype, stack=stack),
    }


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Parameters on the generator's device, blocks stacked (n_layers, ...)."""
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "blocks": block_init(cfg, gen, dtype, stack=(cfg.n_layers,)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def _block_apply(cfg: ArchConfig, p: Params, h: torch.Tensor,
                 use_kernels: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (h, the block's aux loss)."""
    a = attn.self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, use_kernels=use_kernels)
    h = h + a
    m, aux = moe_block(p["moe"], rms_norm(h, p["ln2"], cfg.norm_eps),
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       activation=cfg.activation,
                       router_aux_coef=cfg.router_aux_coef)
    return h + m, aux


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = True):
    """-> (logits (B,T,V), aux_loss: the layers' aux losses summed)."""
    h = tf.embed_tokens(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p in unstack(params["blocks"], cfg.n_layers):
        if remat:
            h, a = checkpoint(_block_apply, cfg, p, h, use_kernels,
                              use_reentrant=False)
        else:
            h, a = _block_apply(cfg, p, h, use_kernels)
        aux = aux + a
    return tf.lm_head(cfg, params, h), aux


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """Zeroed KV cache (L, B, S, KV, D)."""
    shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; pos: next position index.  Routing capacity is
    taken over the B tokens of the step.

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    h = tf.embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        a, _ = attn.decode_self_attention(
            p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cache["k"][i],
            cache["v"][i], pos, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
        h = h + a
        m, _ = moe_block(p["moe"], rms_norm(h, p["ln2"], cfg.norm_eps),
                         top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                         activation=cfg.activation, router_aux_coef=0.0)
        h = h + m
    return tf.lm_head(cfg, params, h), cache
