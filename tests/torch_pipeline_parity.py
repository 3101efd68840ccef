"""Shared pieces of ``tests/test_torch_staging.py`` and
``tests/test_torch_pipeline.py``: the port's pipeline staging and microbatch
pipeline against the JAX package's, on reduced configs.

Both sides get the same JAX-init params, converted through numpy, with two
changes made on the JAX side before the conversion:
- the VLM's gates are opened to 0.5 (``torch_slice_parity.open_gates``), or
  its cross blocks would add nothing and get no gradient;
- the embedding table is rounded to bf16.  Both packages' ``make_io``
  round the embedded input to bf16 before casting it to the activation
  dtype; with a table that bf16 holds exactly (and the reduced gemma's
  embedding scale sqrt(64) = 8, a power of two) that rounding changes
  nothing, so an f32 pipeline can be held to the single-pod model at f32
  precision.  The embedding's gradient through that input still passes
  through bf16 on both sides (``EMBED_GRAD_RTOL``).  ``make_io`` rounds
  the VLM's image embeddings to bf16 too, so ``batch`` draws them in bf16.

Cases: every pipelined family, reduced; zamba2-7b also at 7 layers
(3 applications of the shared block and a 1-layer tail: 4 padded units,
which split over 2 stages).  Batches are numpy, drawn from a seed.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.parallel.pipeline import pipeline_loss_fn
from repro_torch.parallel.staging import build_staging
from repro_torch.train.step import value_and_grad
from torch_slice_parity import modality, open_gates, reduced

CASES = [("gpt-2b", None), ("gemma3-12b", None), ("granite-moe-1b-a400m", None),
         ("mamba2-2.7b", None), ("zamba2-7b", None), ("zamba2-7b", 7),
         ("llama-3.2-vision-90b", None)]
IDS = [a if n is None else f"{a}-{n}l" for a, n in CASES]
B, T, N_MB = 4, 40, 2
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-3, 1e-4
# the embedding gradient's share that comes back through the bf16 input
# (2**-8 relative rounding of each cotangent element, summed per row)
EMBED_GRAD_RTOL = 2 ** -7


def configs(arch, n_layers=None):
    """(reference config, port config)."""
    return reduced(jax_config, arch, n_layers), reduced(get_config, arch, n_layers)


@functools.lru_cache(maxsize=None)
def reference_params(arch, n_layers=None):
    """The JAX init (key 0) as numpy, gates opened, embedding in bf16."""
    cfg = reduced(jax_config, arch, n_layers)
    p = open_gates(cfg, jax.jit(jax_build(cfg).init)(jax.random.PRNGKey(0)))
    p = {**p, "embed": p["embed"].astype(jnp.bfloat16).astype(jnp.float32)}
    return jax.tree.map(np.asarray, p)


def batch(cfg, seed=1, b=B, t=T):
    """Token ids and labels; the VLM's image embeddings rounded to bf16,
    which ``make_io`` rounds them to whatever the activation dtype."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)),
           "labels": rng.integers(0, cfg.vocab_size, (b, t))}
    mod = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
           for k, v in modality(cfg, b, seed=seed + 100).items()}
    return {**out, **mod}


def items(tree, path=()):
    """{"a.b": leaf} of a nested dict (jax or torch leaves)."""
    if not isinstance(tree, dict):
        return {".".join(path): tree}
    out = {}
    for k in sorted(tree):
        out.update(items(tree[k], path + (k,)))
    return out


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(port, ref, *, atol, rtol, norm_rtol, what, through_bf16=()):
    """Every leaf of two trees: elementwise ``atol`` / ``rtol`` and a
    relative norm error under ``norm_rtol``; the leaves named in
    ``through_bf16`` only to ``EMBED_GRAD_RTOL`` of their norm."""
    port, ref = items(port), items(ref)
    assert sorted(port) == sorted(ref), what
    for k, r in ref.items():
        a, b = np32(port[k]), np32(r)
        assert a.shape == b.shape, (what, k)
        if k in through_bf16:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= EMBED_GRAD_RTOL, (what, k, rel)
            continue
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{what} {k}")
        if np.linalg.norm(b) > 0:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= norm_rtol, (what, k, rel)


def pipeline_grads(tcfg, params, S, batch):
    """The port's f32 pipeline (local transport): (staging, loss, metrics,
    grads over ``{"staged", "shared"}``)."""
    st = build_staging(tcfg, S, params, act_dtype=torch.float32)
    loss_fn = pipeline_loss_fn(st, N_MB)
    loss, metrics, grads = value_and_grad(
        lambda t, b: loss_fn(t["staged"], t["shared"], st.consts, b),
        {"staged": st.staged, "shared": st.shared},
        {k: torch.as_tensor(v) for k, v in batch.items()})
    return st, loss, metrics, grads
