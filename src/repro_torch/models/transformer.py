"""Dense decoder-only transformer LMs.

Counterpart of ``repro/models/transformer.py``: minitron-8b, deepseek-7b,
gemma-2b (MQA), gemma3-12b (local:global sliding-window pattern) and the
paper's GPT family.  Blocks are parameter-stacked along a leading layer
axis; the reference's ``lax.scan`` is a Python loop over that axis.  In the
gemma3 pattern every group holds ``ratio`` local layers then one global
layer, so layer ``i`` is global iff ``i % (ratio + 1) == ratio``.

``forward(..., remat=True)`` recomputes activations in the backward, as the
reference's ``jax.checkpoint`` does: per block for plain stacks, per group
of ``ratio + 1`` layers for the gemma3 pattern.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (
    act_dtype_cast, checkpoint, dense_init, embed_init, embed_lookup, layer, linear,
    replicate_dims, rms_norm, shard_act, unstack,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def block_init(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32,
               stack: Tuple[int, ...] = ()) -> Params:
    """One pre-norm attention + MLP block, leaves stacked ``stack``."""
    dev = gen.device
    return {
        "ln1": torch.ones((*stack, cfg.d_model), dtype=dtype, device=dev),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, dtype, stack=stack),
        "ln2": torch.ones((*stack, cfg.d_model), dtype=dtype, device=dev),
        "mlp": mlp_mod.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                dtype, stack=stack),
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


def layer_windows(cfg: ArchConfig) -> Iterator[Tuple[int, int]]:
    """(layer index, attention window) in order; 0 means full attention."""
    ratio = cfg.local_global_ratio
    for i in range(cfg.n_layers):
        glob = bool(ratio) and i % (ratio + 1) == ratio
        yield i, 0 if glob else cfg.sliding_window


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(cfg: ArchConfig, p: Params, h: torch.Tensor, *,
                 window: int, use_kernels: bool) -> torch.Tensor:
    a = attn.self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=window,
        use_kernels=use_kernels)
    h = h + a
    m = mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps), cfg.activation)
    h = h + m
    return shard_act(h, ("batch", "seq", "embed"))


def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    h = act_dtype_cast(embed_lookup(params["embed"], tokens))
    if cfg.scale_embed:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return shard_act(h, ("batch", "seq", "embed"))


def lm_head(cfg: ArchConfig, params: Params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    # a tied table is gathered over its d dim as its lookup gathers it
    # (``embed_lookup``), so the two uses' gradients meet in one placement
    w = (replicate_dims(params["embed"], [1]).T if cfg.tie_embeddings
         else params["lm_head"])
    logits = linear(h, w)
    return shard_act(logits, ("batch_head", "seq", "vocab"))


def _apply_layers(cfg: ArchConfig, layers: List[Tuple[Params, int]],
                  h: torch.Tensor, use_kernels: bool) -> torch.Tensor:
    for p, window in layers:
        h = _block_apply(cfg, p, h, window=window, use_kernels=use_kernels)
    return h


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = True):
    """-> (logits (B,T,V), aux_loss scalar).

    Layer parameters come from one unbind per stacked leaf (``unstack``).
    With ``remat`` each checkpointed segment (a block, or a gemma3 group)
    keeps only its input and recomputes the rest in the backward."""
    h = embed_tokens(cfg, params, batch["tokens"])
    layers = list(zip(unstack(params["blocks"], cfg.n_layers),
                      (w for _, w in layer_windows(cfg))))
    seg = cfg.local_global_ratio + 1 if cfg.local_global_ratio else 1
    for s in range(0, cfg.n_layers, seg):
        if remat:
            h = checkpoint(_apply_layers, cfg, layers[s:s + seg], h, use_kernels)
        else:
            h = _apply_layers(cfg, layers[s:s + seg], h, use_kernels)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return lm_head(cfg, params, h), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               dtype=torch.bfloat16, device=None) -> Params:
    """Zeroed KV cache, in the reference's layouts: (L, B, S, KV, D), or for
    the gemma3 pattern (G, ratio, B, min(S, window), KV, D) local ring
    buffers plus (G, B, S, KV, D) global caches."""
    ratio = cfg.local_global_ratio

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if not ratio:
        S = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
        shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}
    n_groups = cfg.n_layers // (ratio + 1)
    w = cfg.sliding_window
    loc = (n_groups, ratio, batch, min(seq_len, w), cfg.n_kv_heads, cfg.head_dim)
    glb = (n_groups, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k_loc": zeros(loc), "v_loc": zeros(loc),
            "k_glb": zeros(glb), "v_glb": zeros(glb)}


def layer_cache(cfg: ArchConfig, cache: Params, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Views (k, v) of layer ``i``'s slots in a cache from :func:`init_cache`;
    writing into them writes into the cache."""
    ratio = cfg.local_global_ratio
    if not ratio:
        return cache["k"][i], cache["v"][i]
    g, j = divmod(i, ratio + 1)
    if j < ratio:
        return cache["k_loc"][g, j], cache["v_loc"][g, j]
    return cache["k_glb"][g], cache["v_glb"][g]


def _decode_block(cfg: ArchConfig, p: Params, h, ck, cv, pos: int, window: int):
    a, _ = attn.decode_self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), ck, cv, pos,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, window=window)
    h = h + a
    return h + mlp_mod.mlp(p["mlp"], rms_norm(h, p["ln2"], cfg.norm_eps),
                           cfg.activation)


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; pos: next position index.

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    h = embed_tokens(cfg, params, tokens)
    for i, window in layer_windows(cfg):
        ck, cv = layer_cache(cfg, cache, i)
        h = _decode_block(cfg, layer(params["blocks"], i), h, ck, cv, pos, window)
    return lm_head(cfg, params, h), cache
