"""Mamba-2 (SSD) language model, attention-free (mamba2-2.7b).

Counterpart of ``repro/models/mamba_lm.py``.  Blocks are parameter-stacked
along a leading layer axis; the reference's ``lax.scan`` is a Python loop
over that axis.  ``forward(..., remat=True)`` recomputes each block's
activations in the backward, as the reference's ``jax.checkpoint`` per block
does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import (
    checkpoint, dense_init, embed_init, layer, rms_norm, unstack,
)
from repro_torch.models.ssm import (
    ssm_block, ssm_decode_step, ssm_init, ssm_init_state,
)

Params = Dict[str, Any]


def block_init(cfg: ArchConfig, gen: torch.Generator, dtype,
               stack: Tuple[int, ...] = ()) -> Params:
    return {
        "ln": torch.ones((*stack, cfg.d_model), dtype=dtype, device=gen.device),
        "ssm": ssm_init(gen, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                        cfg.n_ssm_heads, cfg.ssm_conv, dtype, stack=stack),
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
                 use_kernels: bool) -> torch.Tensor:
    return h + ssm_block(
        p["ssm"], rms_norm(h, p["ln"], cfg.norm_eps),
        d_inner=cfg.d_inner, d_state=cfg.ssm_state, n_heads=cfg.n_ssm_heads,
        head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk, use_kernels=use_kernels,
        norm_eps=cfg.norm_eps)


def forward(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            use_kernels: bool = False, remat: bool = True):
    """-> (logits (B,T,V), aux_loss scalar 0).  Layer parameters come from
    one unbind per stacked leaf (``unstack``)."""
    h = tf.embed_tokens(cfg, params, batch["tokens"])
    for p in unstack(params["blocks"], cfg.n_layers):
        if remat:
            h = checkpoint(_block_apply, cfg, p, h, use_kernels)
        else:
            h = _block_apply(cfg, p, h, use_kernels)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return tf.lm_head(cfg, params, h), aux


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> Params:
    """Zeroed decode state ``{"s": (L,B,H,P,N), "conv": (L,B,K-1,C)}``.
    ``seq_len`` and ``dtype`` are ignored: the state is f32 and O(1) in the
    sequence length."""
    del seq_len, dtype
    single = ssm_init_state(batch, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_conv, device=device)
    return {k: torch.zeros((cfg.n_layers, *v.shape), dtype=v.dtype, device=device)
            for k, v in single.items()}


def decode_step(cfg: ArchConfig, params: Params, cache: Params,
                tokens: torch.Tensor, pos: int):
    """tokens: (B, 1) int; ``pos`` is unused (SSM decode is position-free).

    Returns (logits (B, 1, V), cache); the cache is updated in place."""
    del pos
    h = tf.embed_tokens(cfg, params, tokens)
    for i in range(cfg.n_layers):
        p = layer(params["blocks"], i)
        out, st = ssm_decode_step(
            p["ssm"], rms_norm(h, p["ln"], cfg.norm_eps),
            {k: v[i] for k, v in cache.items()},
            d_inner=cfg.d_inner, d_state=cfg.ssm_state, n_heads=cfg.n_ssm_heads,
            head_dim=cfg.ssm_head_dim, norm_eps=cfg.norm_eps)
        h = h + out
        for k, v in st.items():
            cache[k][i] = v
    return tf.lm_head(cfg, params, h), cache
