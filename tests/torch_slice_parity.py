"""Shared body of the ``tests/test_torch_slice_*.py`` files: the port's whole
serving slice against the JAX package for one reduced arch.

Both sides get the same JAX-init params (converted through numpy) and the
same numpy prompt.  The reference runs its Pallas kernels (flash attention,
SSD intra-chunk) in interpret mode (``use_pallas=True``); the port runs with
kernels on, which on the CPU is each kernel's plain version.  The prompt (80
tokens) is longer than the reduced sliding window (64), so gemma3's
ring-buffer prefill and windowed decode slots are exercised, and is not a
multiple of the reduced SSM chunk (32), so the SSD padding is.

The serving state is a KV cache (dense) or ``{"s", "conv"}`` (SSM); the SSM
state is f32 whatever the cache dtype, on both sides, so the SSM runs only
the f32 decode (``CACHE_DTYPES``).
"""
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


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The JAX side, computed once per arch and returned as numpy."""
    cfg = jax_config(arch).reduced()
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT))
    logits, _ = model.forward(params, {"tokens": jnp.asarray(tokens)})
    last, cache = jax_prefill(cfg, params, {"tokens": jnp.asarray(tokens)},
                              cache_len=TOTAL, cache_dtype=jnp.float32,
                              use_pallas=True)
    step = jax.jit(model.decode_step)
    runs = {}
    for name in CACHE_DTYPES.get(cfg.family, ("float32", "bfloat16")):
        dtype = getattr(jnp, name)
        # the reference's prefill casts its f32 K/V to the cache dtype
        c = jax.tree.map(lambda x: x.astype(dtype), cache)
        tok = jnp.argmax(last[:, -1:], axis=-1).astype(jnp.int32)
        toks, step_logits = [np.asarray(tok)], []
        for t in range(PROMPT, TOTAL):
            lg, c = step(params, c, tok, jnp.int32(t))
            tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            step_logits.append(np.asarray(lg))
            toks.append(np.asarray(tok))
        runs[name] = (toks, step_logits)
    cache_np = {k: np.asarray(v) for k, v in cache.items()}
    return (jax.tree.map(np.asarray, params), tokens, np.asarray(logits),
            np.asarray(last), cache_np, runs)


def port(arch):
    cfg = get_config(arch).reduced()
    params_np, tokens = reference(arch)[:2]
    return (cfg, build_model(cfg, device="cpu"), params_from_jax(params_np),
            torch.from_numpy(tokens))


def _close(t, ref, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def check_forward(arch):
    cfg, model, params, tokens = port(arch)
    logits, _ = model.forward(params, {"tokens": tokens})
    assert tuple(logits.shape) == (B, PROMPT, cfg.vocab_size)
    _close(logits, reference(arch)[2], TOL)


def check_prefill(arch):
    cfg, model, params, tokens = port(arch)
    last, cache = prefill(cfg, params, {"tokens": tokens}, cache_len=TOTAL,
                          cache_dtype=torch.float32, use_kernels=True)
    ref_last, ref_cache = reference(arch)[3:5]
    _close(last, ref_last, TOL)
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


def check_greedy_decode(arch, cache_dtype):
    """Greedy decode after prefill; both sides are fed the reference's
    tokens, so a tie that breaks differently does not fork the sequences."""
    cfg, model, params, tokens = port(arch)
    ref_toks, ref_logits = reference(arch)[5][cache_dtype]
    tol = TOL if cache_dtype == "float32" else BF16_TOL
    last, cache = prefill(cfg, params, {"tokens": tokens}, cache_len=TOTAL,
                          cache_dtype=getattr(torch, cache_dtype),
                          use_kernels=True)
    _assert_same_token(greedy_tokens(last), ref_toks[0], reference(arch)[3], tol)
    for i, t in enumerate(range(PROMPT, TOTAL)):
        tok = torch.from_numpy(ref_toks[i].astype(np.int64))
        lg, cache = model.decode_step(params, cache, tok, t)
        _close(lg, ref_logits[i], tol)
        _assert_same_token(greedy_tokens(lg), ref_toks[i + 1], ref_logits[i], tol)
