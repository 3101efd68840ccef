"""Whisper-style encoder-decoder backbone (whisper-medium).

Counterpart of ``repro/models/encdec.py``.  The conv frontend is a stub, as
in the reference: the batch carries precomputed frame embeddings
``frames`` (B, enc_frames, d).  Encoder: bidirectional self-attention
blocks.  Decoder: causal self-attention, cross-attention over the encoder's
output (the memory) and an MLP per block.  Absolute learned decoder
positions; no rope.  The parameter tree is the reference's: ``enc_blocks``
(enc_layers, ...) and ``dec_blocks`` (n_layers, ...) stacked, the
reference's scans Python loops over them.  ``forward(..., remat=True)``
recomputes each encoder and each decoder block in the backward, as the
reference's ``jax.checkpoint(body)`` does; the memory's gradient sums the
cross attentions of every decoder layer through autograd.
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
    dense_init, embed_init, embed_lookup, layer, rms_norm, shard_act, unstack,
)

Params = Dict[str, Any]

MAX_DEC_POS = 4096  # decoder learned positions (backbone setting)


def dec_block_init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
                   stack=()) -> Params:
    d, dev = cfg.d_model, gen.device

    def ones():
        return torch.ones((*stack, d), dtype=dtype, device=dev)
    return {
        "ln1": ones(),
        "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               dtype, stack=stack),
        "ln_x": ones(),
        "xattn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                dtype, stack=stack),
        "ln2": ones(),
        "mlp": mlp_mod.mlp_init(gen, d, cfg.d_ff, cfg.activation, dtype,
                                stack=stack),
    }


def init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Parameters on the generator's device, in the reference's tree."""
    d = cfg.d_model
    return {
        "embed": embed_init(gen, cfg.vocab_size, d, dtype),
        "pos_embed": embed_init(gen, MAX_DEC_POS, d, dtype),   # 0.02 N(0, 1)
        "enc_blocks": tf.block_init(cfg, gen, dtype, stack=(cfg.enc_layers,)),
        "enc_norm": torch.ones((d,), dtype=dtype, device=gen.device),
        "dec_blocks": dec_block_init(cfg, gen, dtype, stack=(cfg.n_layers,)),
        "final_norm": torch.ones((d,), dtype=dtype, device=gen.device),
        "lm_head": dense_init(gen, d, cfg.vocab_size, dtype),
    }


def _enc_block(cfg: ArchConfig, p: Params, h: torch.Tensor,
               use_kernels: bool) -> torch.Tensor:
    h = h + attn.self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=0.0, causal=False, use_kernels=use_kernels)
    return h + mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                           cfg.activation)


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor, *,
           use_kernels: bool = False, remat: bool = True) -> torch.Tensor:
    """frames (B, enc_frames, d) -> the memory (B, enc_frames, d)."""
    h = frames
    for p in unstack(params["enc_blocks"], cfg.enc_layers):
        if remat:
            h = checkpoint(_enc_block, cfg, p, h, use_kernels, use_reentrant=False)
        else:
            h = _enc_block(cfg, p, h, use_kernels)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def embed_positions(params: Params, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
    """Token embeddings plus the learned positions start, start + 1, ...
    (modulo MAX_DEC_POS).  No activation-dtype cast and no embedding scale,
    as in the reference.  Placed as the decoder blocks' output is
    (``shard_act``; a no-op but on DTensors), where the reference leaves the
    sum of the two lookups to its partitioner: on DTensors the two
    lookups' placements disagree."""
    pos = torch.arange(start, start + tokens.shape[1], device=tokens.device)
    h = (embed_lookup(params["embed"], tokens)
         + embed_lookup(params["pos_embed"], pos % MAX_DEC_POS)[None])
    return shard_act(h, ("batch", "seq", "embed"))


def _dec_block(cfg: ArchConfig, p: Params, h: torch.Tensor, memory: torch.Tensor,
               use_kernels: bool, return_kv: bool = False):
    """One decoder block.  ``return_kv`` also returns its self attention's
    (k, v) (B, T, KV, D) and its cross attention's memory (k, v) (B, M, KV,
    D), for prefill."""
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, use_kernels=use_kernels, return_kv=return_kv)
    a = attn.self_attention(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                            rope_theta=0.0, causal=True, **kw)
    a, kv = a if return_kv else (a, None)
    h = h + a
    x = attn.cross_attention(p["xattn"], rms_norm(h, p["ln_x"], cfg.norm_eps),
                             memory, **kw)
    x, mem_kv = x if return_kv else (x, None)
    h = h + x
    h = h + mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                        cfg.activation)
    h = shard_act(h, ("batch", "seq", "embed"))
    return (h, kv, mem_kv) if return_kv else h


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = True):
    """-> (logits (B,T,V), aux_loss scalar 0).  ``batch`` holds ``tokens``
    (B, T) and ``frames`` (B, enc_frames, d), cast to the embedding's
    dtype."""
    memory = encode(cfg, params, batch["frames"].to(params["embed"].dtype),
                    use_kernels=use_kernels, remat=remat)
    h = embed_positions(params, batch["tokens"])
    for p in unstack(params["dec_blocks"], cfg.n_layers):
        if remat:
            h = checkpoint(_dec_block, cfg, p, h, memory, use_kernels,
                           use_reentrant=False)
        else:
            h = _dec_block(cfg, p, h, memory, use_kernels)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return tf.lm_head(cfg, params, h), aux


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """Zeroed decode state: the decoder's self-attention K/V ``k`` / ``v``
    (L, B, S, KV, D) and each layer's cross-attention K/V of the memory
    ``mem_k`` / ``mem_v`` (L, B, enc_frames, KV, D), all in ``dtype``."""
    kv = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    mem = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    return {"k": zeros(kv), "v": zeros(kv), "mem_k": zeros(mem), "mem_v": zeros(mem)}


def prefill_memory(cfg: ArchConfig, params: Params, frames: torch.Tensor,
                   cache: Params) -> Params:
    """Encode frames (plain attention, as the reference's jnp default) and
    write each decoder layer's cross-attention K/V into ``cache["mem_k"]`` /
    ``["mem_v"]`` (in place, in the cache dtype)."""
    memory = encode(cfg, params, frames.to(params["embed"].dtype), remat=False)
    for i in range(cfg.n_layers):
        k, v = attn.cross_kv(layer(params["dec_blocks"], i)["xattn"], memory,
                             n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)
        cache["mem_k"][i] = k
        cache["mem_v"][i] = v
    return cache


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; pos: next position index.

    Returns (logits (B, 1, V), cache); the self-attention K/V is updated in
    place, the memory's K/V only read."""
    h = embed_positions(params, tokens, pos)
    for i in range(cfg.n_layers):
        p = layer(params["dec_blocks"], i)
        a, _ = attn.decode_self_attention(
            p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), cache["k"][i],
            cache["v"][i], pos, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=0.0)
        h = h + a
        h = h + attn.decode_cross_attention(
            p["xattn"], rms_norm(h, p["ln_x"], cfg.norm_eps), cache["mem_k"][i],
            cache["mem_v"][i], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim)
        h = h + mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                            cfg.activation)
    return tf.lm_head(cfg, params, h), cache
