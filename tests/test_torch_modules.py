"""Module parity of the port against the JAX package: numpy-seeded inputs,
JAX-init params converted through ``repro_torch.convert``, CPU on both sides.
Also sampling (Gumbel-max with shared noise) and the convert round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.serve.step import gumbel_noise, make_serve_step, sample_tokens

torch.set_num_threads(1)

# f32 on both sides; only summation order differs at these sizes
TOL = 2e-5


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _tree(jtree):
    return params_from_jax(jax.tree.map(np.asarray, jtree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, w = _np(0, 3, 5, 64), _np(1, 64)
    j = jcommon.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-6)
    t = tcommon.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(w), 1e-6)
    assert t.dtype == getattr(torch, dtype)
    # bf16 output: both round the same f32 value; allow one bf16 ulp
    _close(t, j.astype(jnp.float32), 2e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
@pytest.mark.parametrize("offset", [0, 97])
def test_apply_rope(theta, offset):
    x = _np(2, 2, 7, 3, 16)
    pos = np.arange(7) + offset
    j = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    t = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(t, j, 1e-4 if offset else TOL)   # angles up to ~100 rad at offset


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_activate(kind):
    x = _np(3, 4, 33, scale=3.0)
    _close(tcommon.activate(torch.from_numpy(x), kind),
           jcommon.activate(jnp.asarray(x), kind))


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp(activation):
    jp = jmlp.mlp_init(jax.random.PRNGKey(4), 64, 128, activation)
    h = _np(5, 2, 9, 64)
    _close(tmlp.mlp(_tree(jp), torch.from_numpy(h), activation),
           jmlp.mlp(jp, jnp.asarray(h), activation))


ATTN_CASES = [  # (n_heads, n_kv_heads, window)
    (4, 2, 0),      # GQA
    (4, 1, 0),      # MQA
    (4, 2, 24),     # GQA + sliding window
]


@pytest.mark.parametrize("heads,kv_heads,window", ATTN_CASES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_self_attention(heads, kv_heads, window, use_kernels):
    jp = jattn.attn_init(jax.random.PRNGKey(6), 64, heads, kv_heads, 16)
    h = _np(7, 2, 40, 64)
    kw = dict(n_heads=heads, n_kv_heads=kv_heads, head_dim=16,
              rope_theta=10_000.0, causal=True, window=window)
    jo, (jk, jv) = jattn.self_attention(jp, jnp.asarray(h), return_kv=True, **kw)
    to, (tk, tv) = tattn.self_attention(_tree(jp), torch.from_numpy(h),
                                        use_kernels=use_kernels,
                                        return_kv=True, **kw)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


DECODE_CASES = [  # (cache slots S, window, positions)
    (24, 0, [0, 5, 23, 30]),        # full cache; pos >= S clamps to S-1
    (16, 16, [3, 15, 16, 21, 40]),  # ring buffer, incl. pos >= S
]


@pytest.mark.parametrize("S,window,positions", DECODE_CASES)
@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_self_attention(S, window, positions, cache_dtype):
    heads, kv_heads, D = 4, 2, 16
    jp = jattn.attn_init(jax.random.PRNGKey(8), 64, heads, kv_heads, D)
    tp = _tree(jp)
    kw = dict(n_heads=heads, n_kv_heads=kv_heads, head_dim=D,
              rope_theta=10_000.0, window=window)
    ck, cv = _np(9, 2, S, kv_heads, D), _np(10, 2, S, kv_heads, D)
    jck, jcv = jnp.asarray(ck, cache_dtype), jnp.asarray(cv, cache_dtype)
    tdt = getattr(torch, cache_dtype)
    tck, tcv = torch.from_numpy(ck).to(tdt), torch.from_numpy(cv).to(tdt)
    for i, pos in enumerate(positions):
        h = _np(11 + i, 2, 1, 64)
        jo, (jck, jcv) = jattn.decode_self_attention(
            jp, jnp.asarray(h), jck, jcv, jnp.int32(pos), **kw)
        to, (tck, tcv) = tattn.decode_self_attention(
            tp, torch.from_numpy(h), tck, tcv, pos, **kw)
        _close(to, jo, TOL if cache_dtype == "float32" else 1e-2)
        _close(tck, jnp.asarray(jck, jnp.float32),
               TOL if cache_dtype == "float32" else 1e-2)
        _close(tcv, jnp.asarray(jcv, jnp.float32),
               TOL if cache_dtype == "float32" else 1e-2)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def test_jax_categorical_is_gumbel_max():
    """The reference samples with jax.random.categorical; it is
    argmax(logits + gumbel) with the key's own noise."""
    key = jax.random.PRNGKey(12)
    logits = jnp.asarray(_np(13, 8, 512))
    a = jax.random.categorical(key, logits, axis=-1)
    b = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), axis=-1)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1.5])
def test_sampling_matches_reference_with_shared_noise(temperature):
    logits = _np(14, 8, 512, scale=2.0)
    u = np.random.default_rng(15).uniform(1e-9, 1.0, (8, 512))
    g = (-np.log(-np.log(u))).astype(np.float32)
    j = jnp.argmax(jnp.asarray(logits) / temperature + jnp.asarray(g), axis=-1)
    t = sample_tokens(torch.from_numpy(logits), temperature, torch.from_numpy(g))
    np.testing.assert_array_equal(t[:, 0].numpy(), np.asarray(j))


def test_same_generator_seed_gives_same_tokens():
    from repro_torch.api import generate
    kw = dict(batch=2, prompt_len=6, gen_tokens=5, reduced=True, greedy=False,
              temperature=0.8, device="cpu")
    a = generate("gpt-2b", seed=3, **kw)["tokens"]
    b = generate("gpt-2b", seed=3, **kw)["tokens"]
    np.testing.assert_array_equal(a, b)
    gen = torch.Generator().manual_seed(3)
    g1 = gumbel_noise((4, 9), gen)
    gen.manual_seed(3)
    assert torch.equal(g1, gumbel_noise((4, 9), gen))


def test_non_positive_temperature_raises():
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    cfg = get_config("gpt-2b").reduced()
    for temp in (0.0, -1.0):
        with pytest.raises(ValueError, match="temperature"):
            make_serve_step(cfg, greedy=False, temperature=temp, device="cpu")
    with pytest.raises(ValueError, match="temperature"):
        generate("gpt-2b", reduced=True, greedy=False, temperature=0.0,
                 device="cpu")


# ---------------------------------------------------------------------------
# Convert
# ---------------------------------------------------------------------------


def test_convert_round_trip_is_identity():
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config as tget
    from repro_torch.models.transformer import init as tinit

    cfg = tget("gemma3-12b").reduced()
    jp = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(17)))
    jp["extra_bf16"] = np.asarray(jnp.asarray(_np(18, 3, 4), jnp.bfloat16))
    back = params_to_numpy(params_from_jax(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    # the port's own init has the reference's tree paths and shapes
    mine = tinit(cfg, torch.Generator().manual_seed(0))
    del jp["extra_bf16"]
    ref_shapes = jax.tree.map(lambda a: a.shape, jp)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == ref_shapes


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_convert_round_trip_cross_attention_families(arch):
    """The audio and VLM trees (nested, stacked two deep for the VLM's self
    blocks, scalar gates) round-trip bit-equal, and the port's own init
    has the reference's paths and shapes."""
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config as tget
    from repro_torch.models import build_model as tbuild

    cfg = tget(arch).reduced()
    jp = jax.tree.map(np.asarray, jbuild(cfg).init(jax.random.PRNGKey(17)))
    back = params_to_numpy(params_from_jax(jp))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    mine = tbuild(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert (jax.tree.map(lambda t: tuple(t.shape), mine)
            == jax.tree.map(lambda a: a.shape, jp))


# ---------------------------------------------------------------------------
# The rest of the ported surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 20])
def test_attention_chunked(window):
    q, k, v = _np(19, 2, 50, 4, 16), _np(20, 2, 50, 2, 16), _np(21, 2, 50, 2, 16)
    j = jattn.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, window=window, chunk=16)
    t = tattn.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True, window=window,
                                chunk=16)
    _close(t, j)


@pytest.mark.parametrize("window", [0, 8])
def test_init_kv_cache(window):
    jk, jv = jattn.init_kv_cache(2, 20, 2, 16, window=window)
    tk, tv = tattn.init_kv_cache(2, 20, 2, 16, window=window)
    for t, j in ((tk, jk), (tv, jv)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        assert not t.any()


def test_prefill_step_is_the_full_forward():
    from repro.models import build_model as jbuild
    from repro.serve.step import make_prefill_step as jmake
    from repro_torch.configs import get_config as tget
    from repro_torch.serve.step import make_prefill_step

    cfg = tget("gpt-2b").reduced()
    jstep, jmodel, _ = jmake(cfg)
    jp = jmodel.init(jax.random.PRNGKey(22))
    tokens = np.random.default_rng(23).integers(0, cfg.vocab_size, (2, 12))
    tstep, _, _ = make_prefill_step(cfg, device="cpu")
    _close(tstep(_tree(jp), {"tokens": torch.from_numpy(tokens)}),
           jstep(jp, {"tokens": jnp.asarray(tokens)}), 5e-4)


def test_activation_dtype_policy_casts_at_the_embedding():
    from repro_torch.configs import get_config as tget
    from repro_torch.models.transformer import embed_tokens, init

    cfg = tget("gemma-2b").reduced()
    params = init(cfg, torch.Generator().manual_seed(0))
    tokens = torch.zeros(1, 3, dtype=torch.int64)
    assert embed_tokens(cfg, params, tokens).dtype == torch.float32
    try:
        tcommon.set_act_dtype(torch.bfloat16)
        h = embed_tokens(cfg, params, tokens)
    finally:
        tcommon.set_act_dtype(None)
    assert h.dtype == torch.bfloat16
    expect = (params["embed"][tokens].to(torch.bfloat16)
              * torch.tensor(cfg.d_model ** 0.5, dtype=torch.bfloat16))
    assert torch.equal(h, expect)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_softmax_cross_entropy(z_loss):
    logits = _np(20, 3, 5, 50, scale=4.0)
    logits[0, 0, [7, 9]] = 30.0            # a tie: the first index wins
    labels = np.random.default_rng(21).integers(0, 50, (3, 5))
    labels[0, 0] = 7
    jl, ja = jcommon.softmax_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels), z_loss)
    tl, ta = tcommon.softmax_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), z_loss)
    assert tl.dtype == ta.dtype == torch.float32
    _close(tl, jl)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta[0, 0] == 1.0


@pytest.mark.parametrize("mask", ["half", "zero"])
def test_loss_with_loss_mask(mask):
    """The ``loss_mask`` branch, with its max(sum(mask), 1) denominator."""
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = jax_config("gpt-2b").reduced()
    jmodel = jax_build(cfg)
    params = jmodel.init(jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 12)),
             "loss_mask": (rng.random((2, 12)) < 0.5).astype(np.float32)
             * (mask == "half")}
    jt, jm = jmodel.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = build_model(get_config("gpt-2b").reduced(), device="cpu")
    tt, tm = tmodel.loss(_tree(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tt, jt)
    for k in ("loss", "aux_loss", "accuracy"):
        _close(tm[k], jm[k])
