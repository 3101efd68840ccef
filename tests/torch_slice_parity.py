"""Shared body of the ``tests/test_torch_slice_*.py`` files: the port's whole
serving slice against the JAX package for one reduced arch.

Both sides get the same JAX-init params (converted through numpy) and the
same numpy prompt.  The reference runs its Pallas kernels (flash attention,
SSD intra-chunk) in interpret mode (``use_pallas=True``); the port runs with
kernels on, which on the CPU is each kernel's plain version.  The prompt (80
tokens) is longer than the reduced sliding window (64), so gemma3's
ring-buffer prefill and windowed decode slots are exercised, and is not a
multiple of the reduced SSM chunk (32), so the SSD padding is.

The serving state is a KV cache (dense), ``{"s", "conv"}`` (SSM) or both
(hybrid: ``ssm_groups`` / ``ssm_tail`` dicts beside the shared block's
``k`` / ``v``), compared leaf by leaf under its path (``flat``).  The SSM
state is f32 whatever the cache dtype, on both sides, so the SSM runs only
the f32 decode (``CACHE_DTYPES``); the hybrid's bf16 decode casts only its
K/V.  ``n_layers`` replaces the reduced depth (the hybrid's 5-layer variant
has a tail of one SSD layer, the reduced config none).

The VLM and audio families also take their stub frontend's input,
``image_embeds`` / ``frames`` (B, rows, d), drawn with numpy from a seed as
N(0, 1): unit scale, so the memory moves the logits as much as the tokens
do (``generate`` draws 0.02 N(0, 1)).  Their caches add each cross layer's
K/V of that memory.  The VLM's tanh gates start at 0, which would hide its
cross blocks from every comparison, so both sides run with them at 0.5
(``open_gates``, on the JAX side before the conversion).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models.prefill import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models.api import MODALITY
from repro_torch.models.prefill import prefill
from repro_torch.serve.step import greedy_tokens

B, PROMPT, N_DECODE = 2, 80, 6
TOTAL = PROMPT + N_DECODE
# f32 end to end: the reference's own prefill/decode bound (test_serving.py)
TOL = 5e-4
# bf16 cache: both sides round the f32 K/V to bf16, but an entry whose f32
# value differs in its last bits can round to the neighbouring bf16 value
# (2**-8 relative; about 10 of 22016 entries per cache tensor at these
# sizes), which moves the logits by ~2e-4; 2e-3 leaves a 10x margin
BF16_TOL = 2e-3
CACHE_DTYPES = {"ssm": ("float32",)}


def reduced(get_config_fn, arch, n_layers=None):
    """``arch``'s reduced config from one package, at ``n_layers`` if given."""
    cfg = get_config_fn(arch).reduced()
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def flat(tree, path=""):
    """A nested cache -> {"a.b": leaf}, so nested and flat caches compare
    the same way."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{path}.{k}" if path else k))
    return out


def modality(cfg, batch, seed=2):
    """The family's stub frontend input as numpy f32 N(0, 1), ``{}`` for
    the token-only families."""
    if cfg.family not in MODALITY:
        return {}
    key, rows = MODALITY[cfg.family]
    x = np.random.default_rng(seed).standard_normal(
        (batch, getattr(cfg, rows), cfg.d_model))
    return {key: x.astype(np.float32)}


def open_gates(cfg, params, value=0.5):
    """The VLM's params with every cross block's ``gate_a`` / ``gate_m`` at
    ``value``; other families' params as they are."""
    if cfg.family != "vlm":
        return params
    cross = dict(params["cross_blocks"])
    for g in ("gate_a", "gate_m"):
        cross[g] = jnp.full_like(cross[g], value)
    return {**params, "cross_blocks": cross}


@functools.lru_cache(maxsize=None)
def reference(arch, n_layers=None):
    """The JAX side, computed once per arch and returned as numpy."""
    cfg = reduced(jax_config, arch, n_layers)
    model = jax_build(cfg)
    params = open_gates(cfg, model.init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT))
    feed = {"tokens": jnp.asarray(tokens),
            **{k: jnp.asarray(v) for k, v in modality(cfg, B).items()}}
    logits, _ = model.forward(params, feed)
    last, cache = jax_prefill(cfg, params, feed, cache_len=TOTAL,
                              cache_dtype=jnp.float32, use_pallas=True)
    step = jax.jit(model.decode_step)
    runs = {}
    for name in CACHE_DTYPES.get(cfg.family, ("float32", "bfloat16")):
        dtype = getattr(jnp, name)
        # the reference's prefill casts its f32 K/V to the cache dtype; each
        # leaf takes the dtype of the family's cache (SSD states stay f32)
        c = jax.tree.map(lambda x, t: x.astype(t.dtype), cache,
                         model.init_cache(B, TOTAL, dtype))
        tok = jnp.argmax(last[:, -1:], axis=-1).astype(jnp.int32)
        toks, step_logits = [np.asarray(tok)], []
        for t in range(PROMPT, TOTAL):
            lg, c = step(params, c, tok, jnp.int32(t))
            tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            step_logits.append(np.asarray(lg))
            toks.append(np.asarray(tok))
        runs[name] = (toks, step_logits)
    cache_np = {k: np.asarray(v) for k, v in flat(cache).items()}
    return (jax.tree.map(np.asarray, params), tokens, np.asarray(logits),
            np.asarray(last), cache_np, runs)


def port(arch, n_layers=None):
    """(cfg, model, params, feed): the reference's params and prompt, and
    the family's frontend input, as tensors."""
    cfg = reduced(get_config, arch, n_layers)
    params_np, tokens = reference(arch, n_layers)[:2]
    feed = {"tokens": torch.from_numpy(tokens),
            **{k: torch.from_numpy(v) for k, v in modality(cfg, B).items()}}
    return cfg, build_model(cfg, device="cpu"), params_from_jax(params_np), feed


def _close(t, ref, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def check_forward(arch, n_layers=None):
    cfg, model, params, feed = port(arch, n_layers)
    logits, _ = model.forward(params, feed)
    assert tuple(logits.shape) == (B, PROMPT, cfg.vocab_size)
    _close(logits, reference(arch, n_layers)[2], TOL)


def check_prefill(arch, n_layers=None):
    cfg, model, params, feed = port(arch, n_layers)
    last, cache = prefill(cfg, params, feed, cache_len=TOTAL,
                          cache_dtype=torch.float32, use_kernels=True)
    ref_last, ref_cache = reference(arch, n_layers)[3:5]
    _close(last, ref_last, TOL)
    cache = flat(cache)
    assert sorted(cache) == sorted(ref_cache)
    for key, ref in ref_cache.items():
        assert tuple(cache[key].shape) == ref.shape, key
        _close(cache[key], ref, TOL)


def _assert_same_token(tok, ref_tok, ref_logits, tol):
    """The port's greedy pick equals the reference's, except at a tie within
    the test's own tolerance: there the reference must score the port's
    pick within ``tol`` of its maximum."""
    tok = tok.numpy().ravel()
    ref_tok = np.asarray(ref_tok).ravel()
    ref_logits = np.asarray(ref_logits, np.float32).reshape(len(tok), -1)
    for b in np.flatnonzero(tok != ref_tok):
        gap = ref_logits[b].max() - ref_logits[b, tok[b]]
        assert gap <= tol, f"row {b}: token {tok[b]} vs {ref_tok[b]}, gap {gap}"


def check_greedy_decode(arch, cache_dtype, n_layers=None):
    """Greedy decode after prefill; both sides are fed the reference's
    tokens, so a tie that breaks differently does not fork the sequences."""
    cfg, model, params, feed = port(arch, n_layers)
    ref_toks, ref_logits = reference(arch, n_layers)[5][cache_dtype]
    tol = TOL if cache_dtype == "float32" else BF16_TOL
    last, cache = prefill(cfg, params, feed, cache_len=TOTAL,
                          cache_dtype=getattr(torch, cache_dtype),
                          use_kernels=True)
    _assert_same_token(greedy_tokens(last), ref_toks[0],
                       reference(arch, n_layers)[3], tol)
    for i, t in enumerate(range(PROMPT, TOTAL)):
        tok = torch.from_numpy(ref_toks[i].astype(np.int64))
        lg, cache = model.decode_step(params, cache, tok, t)
        _close(lg, ref_logits[i], tol)
        _assert_same_token(greedy_tokens(lg), ref_toks[i + 1], ref_logits[i], tol)
