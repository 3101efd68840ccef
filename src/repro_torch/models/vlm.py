"""Llama-3.2-Vision-style VLM backbone: a decoder with a gated
cross-attention image block after every ``cross_attn_every - 1`` self
blocks (llama-3.2-vision-90b).

Counterpart of ``repro/models/vlm.py``.  The vision tower is a stub, as in
the reference: the batch carries precomputed patch embeddings
``image_embeds`` (B, n_image_tokens, d).  100 layers = 20 groups of (4 self
blocks + 1 cross block).  The parameter tree is the reference's:
``self_blocks`` stacked (n_groups, n_self, ...), ``cross_blocks``
(n_groups, ...), whose ``gate_a`` / ``gate_m`` start at 0, so at init a
cross block adds nothing.  ``forward(..., remat=True)`` recomputes one
group (its self blocks and its cross block) at a time in the backward, as
the reference's ``jax.checkpoint(group_body)`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import (
    dense_init, embed_init, layer, rms_norm, unstack,
)

Params = Dict[str, Any]


def _group_dims(cfg: ArchConfig):
    """(groups, self blocks per group)."""
    gsz = cfg.cross_attn_every
    return cfg.n_layers // gsz, gsz - 1


def cross_block_init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                     stack=()) -> Params:
    d, dev = cfg.d_model, gen.device

    def full(shape, value):
        return torch.full((*stack, *shape), value, dtype=dtype, device=dev)
    return {
        "ln1": full((d,), 1.0),
        "xattn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                dtype, stack=stack),
        "gate_a": full((), 0.0),
        "ln2": full((d,), 1.0),
        "mlp": mlp_mod.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype,
                                stack=stack),
        "gate_m": full((), 0.0),
    }


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Parameters on the generator's device, in the reference's tree."""
    n_groups, n_self = _group_dims(cfg)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "self_blocks": tf.block_init(cfg, gen, dtype, stack=(n_groups, n_self)),
        "cross_blocks": cross_block_init(cfg, gen, dtype, stack=(n_groups,)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=gen.device),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }


def _gate(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """tanh of a gate, taken in f32, in ``like``'s dtype."""
    return torch.tanh(g.float()).to(like.dtype)


def _cross_mlp(cfg: ArchConfig, p: Params, h: torch.Tensor, a: torch.Tensor):
    """The cross block after its attention ``a``: both gated residuals."""
    h = h + _gate(p["gate_a"], h) * a
    m = mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg.activation)
    return h + _gate(p["gate_m"], h) * m


def _cross_apply(cfg: ArchConfig, p: Params, h: torch.Tensor, memory: torch.Tensor,
                 *, use_kernels: bool, return_kv: bool = False):
    """One cross block; ``return_kv`` also returns its memory K/V."""
    res = attn.cross_attention(
        p["xattn"], rms_norm(h, p["ln1"], cfg.norm_eps), memory,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        use_kernels=use_kernels, return_kv=return_kv)
    a, kv = res if return_kv else (res, None)
    h = _cross_mlp(cfg, p, h, a)
    return (h, kv) if return_kv else h


def _group_apply(cfg: ArchConfig, pg_self: Params, pg_cross: Params,
                 h: torch.Tensor, memory: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    """A group's self blocks, then its cross block."""
    for p in unstack(pg_self, _group_dims(cfg)[1]):
        h = tf._block_apply(cfg, p, h, window=0, use_kernels=use_kernels)
    return _cross_apply(cfg, pg_cross, h, memory, use_kernels=use_kernels)


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = True):
    """-> (logits (B,T,V), aux_loss scalar 0).  ``batch`` holds ``tokens``
    (B, T) and ``image_embeds`` (B, n_image_tokens, d), cast to the
    activations' dtype.  Groups and their self blocks come from one unbind
    per stacked leaf (``unstack``) at each level."""
    h = tf.embed_tokens(cfg, params, batch["tokens"])
    memory = batch["image_embeds"].to(h.dtype)
    n_groups = _group_dims(cfg)[0]
    groups = zip(unstack(params["self_blocks"], n_groups),
                 unstack(params["cross_blocks"], n_groups))
    for pg_self, pg_cross in groups:
        args = (cfg, pg_self, pg_cross, h, memory, use_kernels)
        h = (checkpoint(_group_apply, *args, use_reentrant=False) if remat
             else _group_apply(*args))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return tf.lm_head(cfg, params, h), aux


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """Zeroed decode state: the self blocks' K/V ``k`` / ``v`` (n_groups,
    n_self, B, S, KV, D) and each cross block's K/V of the image memory
    ``mem_k`` / ``mem_v`` (n_groups, B, n_image_tokens, KV, D), all in
    ``dtype``."""
    n_groups, n_self = _group_dims(cfg)
    kv = (n_groups, n_self, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    mem = (n_groups, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"k": zeros(kv), "v": zeros(kv), "mem_k": zeros(mem), "mem_v": zeros(mem)}


def prefill_cross_kv(cfg: ArchConfig, params: Params, image_embeds: torch.Tensor,
                     cache: Params) -> Params:
    """Write each cross block's K/V of the image memory into
    ``cache["mem_k"]`` / ``["mem_v"]`` (in place, in the cache dtype)."""
    for g in range(_group_dims(cfg)[0]):
        k, v = attn.cross_kv(layer(params["cross_blocks"], g)["xattn"], image_embeds,
                             n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)
        cache["mem_k"][g] = k
        cache["mem_v"][g] = v
    return cache


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; pos: next position index.

    Returns (logits (B, 1, V), cache); the self blocks' K/V is updated in
    place, the memory's K/V only read."""
    h = tf.embed_tokens(cfg, params, tokens)
    n_groups, n_self = _group_dims(cfg)
    for g in range(n_groups):
        pg_self = layer(params["self_blocks"], g)
        for j in range(n_self):
            h = tf._decode_block(cfg, layer(pg_self, j), h, cache["k"][g, j],
                                 cache["v"][g, j], pos, 0)
        pc = layer(params["cross_blocks"], g)
        a = attn.decode_cross_attention(
            pc["xattn"], rms_norm(h, pc["ln1"], cfg.norm_eps), cache["mem_k"][g],
            cache["mem_v"][g], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim)
        h = _cross_mlp(cfg, pc, h, a)
    return tf.lm_head(cfg, params, h), cache
