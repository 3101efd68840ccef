"""Cross attention of the port against the JAX package: ``cross_attention``
(train / prefill, through the flash path when ``use_kernels``) and
``decode_cross_attention`` (plain, over a cached memory K/V in f32 or
bf16), at ragged non-causal shapes: 24 queries over 40 memory rows, D 16
and 64, MHA and GQA 2, with ``memory_kv`` and ``return_kv``.  JAX-init
params converted through numpy, numpy-seeded inputs, CPU on both sides; the
reference's flash path is its Pallas kernel in interpret mode.

Tolerances, f32 on both sides, only summation orders differ: outputs and
K/V 2e-5 (the port's module tolerance); gradients through the flash path
(the port's plain K2/K3 contract against the reference's Pallas backward)
atol 5e-5 / rtol 1e-3, the reference's gradient tolerance.  A bf16 memory
K/V is read the same way on both sides (f32 scores of the rounded values),
so it keeps 2e-5.  Also each family's precomputed memory K/V
(``encdec.prefill_memory``, ``vlm.prefill_cross_kv``) against the
reference's, in an f32 and a bf16 cache (the bf16 one compared after both
sides round the same f32 values: within one bf16 ulp, 2**-8 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import encdec as jencdec
from repro.models import vlm as jvlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, encdec, vlm

torch.set_num_threads(1)

TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-3
B, T, M, D_MODEL = 2, 24, 40, 64

# (heads, kv heads, head dim)
SHAPES = [(4, 4, 16), (4, 2, 16), (2, 2, 64), (4, 2, 64)]


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, atol=TOL, rtol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=rtol)


def _setup(H, KV, D):
    jp = jattn.attn_init(jax.random.PRNGKey(H * 100 + KV * 10 + D), D_MODEL,
                         H, KV, D)
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(jp), _np(1, B, T, D_MODEL), _np(2, B, M, D_MODEL)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_cross_attention_matches_reference(H, KV, D, kernels):
    jp, tp, h, mem = _setup(H, KV, D)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=D)
    j_out, (jk, jv) = jattn.cross_attention(
        jp, jnp.asarray(h), jnp.asarray(mem), use_pallas=kernels,
        return_kv=True, **kw)
    t_out, (tk, tv) = tattn.cross_attention(
        tp, torch.from_numpy(h), torch.from_numpy(mem), use_kernels=kernels,
        return_kv=True, **kw)
    assert tuple(t_out.shape) == (B, T, D_MODEL)
    assert tuple(tk.shape) == (B, M, KV, D)
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)
    # the memory's K/V given: the same output, without the memory
    again = tattn.cross_attention(tp, torch.from_numpy(h), None,
                                  memory_kv=(tk, tv), use_kernels=kernels, **kw)
    _close(again, j_out)
    np.testing.assert_array_equal(
        tattn.cross_kv(tp, torch.from_numpy(mem), n_kv_heads=KV,
                       head_dim=D)[0].numpy(), tk.numpy())


@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_cross_attention_gradients_match_reference(H, KV, D):
    """Through the flash path on both sides: the port's FlashAttention
    (plain K2/K3 contract on the CPU) against ``jax.grad`` of the
    reference's Pallas kernel in interpret mode; the memory's gradient
    flows through both K and V."""
    jp, tp, h, mem = _setup(H, KV, D)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=D)
    g = _np(3, B, T, D_MODEL)

    def jloss(p, hh, mm):
        out = jattn.cross_attention(p, hh, mm, use_pallas=True, **kw)
        return jnp.sum(out * g)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(h), jnp.asarray(mem))

    tp = {k: v.requires_grad_() for k, v in tp.items()}
    th, tm = (torch.from_numpy(x).requires_grad_() for x in (h, mem))
    out = tattn.cross_attention(tp, th, tm, use_kernels=True, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    for name in ("wq", "wk", "wv", "wo"):
        _close(tp[name].grad, jg[0][name], GRAD_ATOL, GRAD_RTOL)
    _close(th.grad, jg[1], GRAD_ATOL, GRAD_RTOL)
    _close(tm.grad, jg[2], GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,D", SHAPES)
def test_decode_cross_attention_matches_reference(H, KV, D, cache_dtype):
    jp, tp, h, mem = _setup(H, KV, D)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=D)
    h1 = h[:, :1]
    jk, jv = jattn.cross_attention(jp, jnp.asarray(h), jnp.asarray(mem),
                                   return_kv=True, **kw)[1]
    jk, jv = (x.astype(getattr(jnp, cache_dtype)) for x in (jk, jv))
    j_out = jattn.decode_cross_attention(jp, jnp.asarray(h1), jk, jv, **kw)
    tk, tv = tattn.cross_kv(tp, torch.from_numpy(mem), n_kv_heads=KV, head_dim=D)
    tk, tv = (x.to(getattr(torch, cache_dtype)) for x in (tk, tv))
    t_out = tattn.decode_cross_attention(tp, torch.from_numpy(h1), tk, tv, **kw)
    assert t_out.dtype == torch.float32 and tuple(t_out.shape) == (B, 1, D_MODEL)
    _close(t_out, j_out)
    # decode of one query is the full cross attention's row for that query
    full = tattn.cross_attention(tp, torch.from_numpy(h), None,
                                 memory_kv=(tk.float(), tv.float()), **kw)
    _close(t_out, full[:, :1].detach().numpy())


# (arch, the reference's function, the port's, the memory's row count)
PRECOMPUTE = [("whisper-medium", jencdec.prefill_memory, encdec.prefill_memory,
               "enc_frames"),
              ("llama-3.2-vision-90b", jvlm.prefill_cross_kv,
               vlm.prefill_cross_kv, "n_image_tokens")]


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,jfn,tfn,rows", PRECOMPUTE)
def test_precomputed_memory_kv_matches_reference(arch, jfn, tfn, rows, cache_dtype):
    """The reduced config's whole cache after the memory's K/V is written:
    ``mem_k`` / ``mem_v`` per cross layer, the self-attention K/V left
    zero.  whisper encodes its frames first; the VLM projects its image
    embeddings as they are."""
    cfg = jax_config(arch).reduced()
    jmodel = jax_build(cfg)
    jp = jmodel.init(jax.random.PRNGKey(3))
    mem = _np(4, B, getattr(cfg, rows), cfg.d_model)
    jc = jfn(cfg, jp, jnp.asarray(mem),
             jmodel.init_cache(B, 16, getattr(jnp, cache_dtype)))
    tcfg = get_config(arch).reduced()
    cache = build_model(tcfg, device="cpu").init_cache(
        B, 16, getattr(torch, cache_dtype))
    out = tfn(tcfg, params_from_jax(jax.tree.map(np.asarray, jp)),
              torch.from_numpy(mem), cache)
    assert out is cache and sorted(cache) == sorted(jc)
    tol = TOL if cache_dtype == "float32" else 2 ** -8
    for key, ref in jc.items():
        assert cache[key].dtype == getattr(torch, cache_dtype)
        assert tuple(cache[key].shape) == ref.shape, key
        _close(cache[key], ref.astype(jnp.float32), tol, tol)
    assert bool(cache["mem_k"].abs().sum() > 0) and not bool(cache["k"].any())
