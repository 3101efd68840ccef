"""Shared body of the ``tests/test_torch_train_*.py`` files: the port's
training slice against the JAX package for one reduced arch.

Both sides get the same JAX-init params (converted through numpy) and the
same ``make_batch`` batches.  The port runs with kernels on, which on the
CPU is each kernel's plain version: the flash forward and the plain K2/K3
backward contract (``kernels/ref.py``) behind ``FlashAttention``, and the
SSD intra-chunk oracle with its VJP behind ``SSDIntra``.  The reference
runs its Pallas kernels in interpret mode where the test asks for it
(``use_pallas=True``), else its jnp versions, as its ``fit`` does.  The
sequence (80 tokens) is longer than the reduced sliding window (64) and not
a multiple of the reduced SSM chunk (32).

Tolerances, all f32 on both sides, only summation orders differ:
- loss and metrics: 1e-5 relative (a mean over 320 tokens of values ~6);
- gradients: atol 1e-5, rtol 1e-3 of each element, and a per-leaf relative
  norm error under 1e-4;
- after AdamW steps: the update is ``lr * m / (sqrt(v) + 1e-8)``, which for
  a gradient element near 0 turns a rounding difference of ~1e-8 into an
  update difference of up to ~lr.  Parameters are held to atol 2 * lr *
  steps (PARAM_ATOL_PER_STEP) and must agree to 1e-4 in relative norm per
  leaf; mu to atol 1e-6 and nu to atol 1e-8 with rtol 1e-3; the metrics
  (taken before each update) to 1e-4 relative.  Measured after 10 steps over
  the five dense archs at 1 and 2 microbatches: params at most 7.8e-6
  apart (relative norm 6.8e-7), mu 1.4e-7, nu 5.1e-8, step-10 loss 2.3e-7
  relative; mamba2-2.7b: params 2.9e-6 apart (relative norm 7.9e-6), mu
  8.9e-8, nu 2.0e-8, step-10 loss 8.1e-8 relative.  No element hit the
  near-zero amplification here.

``n_layers`` replaces the reduced depth (the hybrid's 5-layer variant, whose
tail holds one SSD layer).

The VLM's and the audio family's batches add their frontend input
(``torch_slice_parity.modality``, seeded by the step), and the VLM's gates
are opened to 0.5 on the JAX side before the conversion
(``torch_slice_parity.open_gates``): at 0 its cross blocks' attention and
MLP would get zero gradients.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import build_model as jax_build
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (
    batch_to_device, make_train_step, value_and_grad,
)
from torch_slice_parity import modality, open_gates, reduced

B, T = 4, 80
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL, GRAD_NORM_RTOL = 1e-5, 1e-3, 1e-4
LR = 1e-3
PARAM_ATOL_PER_STEP = 2 * LR
METRIC_RTOL = 1e-4
OPT = dict(lr=LR, warmup_steps=3, total_steps=10)
# leaves that must get a non-zero gradient: the ones the family's kernel feeds
LIVE_LEAVES = {"dense": ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv"),
               "moe": ("blocks.attn.wq", "blocks.attn.wk", "blocks.attn.wv",
                       "blocks.moe.router", "blocks.moe.w_up",
                       "blocks.moe.w_gate", "blocks.moe.w_down"),
               "ssm": ("blocks.ssm.in_proj", "blocks.ssm.A_log",
                       "blocks.ssm.dt_bias"),
               "hybrid": ("shared.attn.wq", "shared.attn.wk", "shared.attn.wv",
                          "shared.attn.wo", "adapt_in", "adapt_out",
                          "groups.ssm.in_proj", "groups.ssm.A_log"),
               "vlm": ("self_blocks.attn.wq", "self_blocks.attn.wk",
                       "cross_blocks.xattn.wq", "cross_blocks.xattn.wk",
                       "cross_blocks.xattn.wv", "cross_blocks.mlp.w_up",
                       "cross_blocks.gate_a", "cross_blocks.gate_m"),
               # the memory's gradient reaches the encoder through every
               # decoder layer's cross attention
               "audio": ("enc_blocks.attn.wq", "enc_blocks.attn.wk",
                         "enc_blocks.mlp.w_up", "dec_blocks.attn.wq",
                         "dec_blocks.xattn.wq", "dec_blocks.xattn.wk",
                         "dec_blocks.xattn.wv", "pos_embed")}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield ".".join(path), tree


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def assert_tree_close(port, ref, *, atol, rtol, norm_rtol=None, what=""):
    ref = dict(_leaves(ref))
    port = dict(_leaves(port))
    assert sorted(port) == sorted(ref), (sorted(port), sorted(ref))
    for name, r in ref.items():
        a, b = _np(port[name]), _np(r)
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=f"{what} {name}")
        if norm_rtol is not None and np.linalg.norm(b) > 0:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= norm_rtol, (what, name, rel)


def batch(cfg, step):
    return {**jax_make_batch(JaxDataConfig(cfg.vocab_size, T, B, seed=0), step),
            **modality(cfg, B, seed=100 + step)}


@functools.lru_cache(maxsize=None)
def reference_grads(arch, use_pallas, n_layers=None):
    cfg = reduced(jax_config, arch, n_layers)
    model = jax_build(cfg, use_pallas=use_pallas)
    params = open_gates(cfg, model.init(jax.random.PRNGKey(0)))
    b = {k: jnp.asarray(v) for k, v in batch(cfg, 0).items()}
    (loss, metrics), grads = jax.value_and_grad(model.loss, has_aux=True)(params, b)
    tonp = functools.partial(jax.tree.map, np.asarray)
    return tonp(params), float(loss), tonp(metrics), tonp(grads)


def check_loss_and_grads(arch, use_pallas, n_layers=None):
    """``loss``, its metrics and every gradient against the reference's
    ``jax.value_and_grad(model.loss)``.  Returns the port's gradients."""
    params_np, loss, metrics, grads = reference_grads(arch, use_pallas, n_layers)
    cfg = reduced(get_config, arch, n_layers)
    model = build_model(cfg, device="cpu")
    params = params_from_jax(params_np)
    t_loss, t_metrics, t_grads = value_and_grad(
        model.loss, params, batch_to_device(batch(cfg, 0), model.device))
    np.testing.assert_allclose(t_loss.item(), loss, rtol=LOSS_RTOL)
    assert sorted(t_metrics) == sorted(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(t_metrics[k].item(), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    assert_tree_close(t_grads, grads, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                      norm_rtol=GRAD_NORM_RTOL, what="grad")
    # the leaves behind the family's kernel really get a gradient
    leaves = dict(_leaves(t_grads))
    for name in LIVE_LEAVES[cfg.family]:
        assert np.abs(_np(leaves[name])).sum() > 0, name
    return t_grads


SNAPSHOT_STEPS = (1, 10)


@functools.lru_cache(maxsize=None)
def reference_training(arch, n_microbatches, n_layers=None):
    """One reference run of max(SNAPSHOT_STEPS) steps: the initial params,
    and (params, opt state) after each snapshot step, plus every step's
    metrics."""
    cfg = reduced(jax_config, arch, n_layers)
    step_fn, model, opt_init = jax_make_train_step(
        cfg, JaxOptimizerConfig(**OPT), n_microbatches=n_microbatches)
    params = open_gates(cfg, model.init(jax.random.PRNGKey(0)))
    start = jax.tree.map(np.asarray, params)
    state = opt_init(params)
    step_fn = jax.jit(step_fn)
    history, snaps = [], {}
    tonp = functools.partial(jax.tree.map, np.asarray)
    for s in range(max(SNAPSHOT_STEPS)):
        b = {k: jnp.asarray(v) for k, v in batch(cfg, s).items()}
        params, state, m = step_fn(params, state, b)
        history.append({k: float(v) for k, v in m.items()})
        if s + 1 in SNAPSHOT_STEPS:
            snaps[s + 1] = (tonp(params), tonp(state))
    return start, snaps, history


def check_training(arch, n_microbatches, steps, n_layers=None):
    """``make_train_step`` for ``steps`` steps: params, optimizer state and
    the metrics of every step against the reference."""
    start, snaps, hist_ref = reference_training(arch, n_microbatches, n_layers)
    params_ref, state_ref = snaps[steps]
    cfg = reduced(get_config, arch, n_layers)
    step_fn, model, opt_init = make_train_step(
        cfg, OptimizerConfig(**OPT), n_microbatches=n_microbatches, device="cpu")
    params = params_from_jax(start)
    state = opt_init(params)
    for s in range(steps):
        params, state, m = step_fn(params, state, batch(cfg, s))
        assert sorted(m) == sorted(hist_ref[s])
        for k, v in hist_ref[s].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=METRIC_RTOL,
                                       atol=1e-7, err_msg=f"step {s + 1} {k}")
    assert int(state.step) == int(state_ref.step) == steps
    assert_tree_close(params, params_ref, atol=PARAM_ATOL_PER_STEP * steps,
                      rtol=0, norm_rtol=1e-4, what="params")
    assert_tree_close(state.mu, state_ref.mu, atol=1e-6, rtol=1e-3, what="mu")
    assert_tree_close(state.nu, state_ref.nu, atol=1e-8, rtol=1e-3, what="nu")
