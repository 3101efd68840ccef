"""The hybrid family's pieces against the JAX package: the shared block's
gradient per application and as a sum, the parameter tree through
``params_from_jax``, and the decode cache's layout.

zamba2-7b reduced (2 applications of the shared block, no tail) and its
5-layer variant (a tail of one SSD layer).  The shared block's weights are
applied once per group, so their gradient sums one contribution per
application, and the group remat recomputes each application in the
backward.  ``untied`` runs each package's own ``_block_apply`` and
``_shared_apply`` with one copy of the shared weights per application: its
loss equals the tied ``forward``'s, each copy's gradient is that
application's contribution (held against the reference's copy), and the
copies' sum is the tied gradient.  Tolerances are torch_train_parity's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as tp
from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.models import hybrid_lm as jax_hybrid
from repro.models import mamba_lm as jax_mamba
from repro.models import transformer as jax_tf
from repro.models.common import softmax_cross_entropy as jax_xent
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.models import build_model, hybrid_lm, mamba_lm, transformer
from repro_torch.models.common import softmax_cross_entropy, unstack
from repro_torch.train.step import batch_to_device, value_and_grad
from torch_slice_parity import reduced

torch.set_num_threads(1)

ARCH = "zamba2-7b"
DEPTHS = [None, 5]


def _jax_untied_loss(cfg, params, shared_copies, batch):
    """The reference's forward with application g using shared_copies[g]."""
    h = jax_tf.embed_tokens(cfg, params, batch["tokens"])
    k = cfg.shared_attn_every
    for g in range(jax_hybrid._n_apps(cfg)):
        for j in range(k):
            p = jax.tree.map(lambda x: x[g, j], params["groups"])
            h = jax_mamba._block_apply(cfg, p, h, use_pallas=True)
        h = jax_hybrid._shared_apply(cfg, shared_copies[g], params["adapt_in"][g],
                                     params["adapt_out"][g], h, use_pallas=True)
    for i in range(jax_hybrid._n_tail(cfg)):
        p = jax.tree.map(lambda x: x[i], params["tail"])
        h = jax_mamba._block_apply(cfg, p, h, use_pallas=True)
    per_tok, _ = jax_xent(jax_tf.lm_head(cfg, params, h), batch["labels"])
    return jnp.mean(per_tok)


def _torch_untied_loss(cfg, params, shared_copies, batch):
    """The port's forward with application g using shared_copies[g]."""
    h = transformer.embed_tokens(cfg, params, batch["tokens"])
    n_apps = hybrid_lm._n_apps(cfg)
    for g, pg in enumerate(unstack(params["groups"], n_apps)):
        for p in unstack(pg, cfg.shared_attn_every):
            h = mamba_lm._block_apply(cfg, p, h, True)
        h = hybrid_lm._shared_apply(cfg, shared_copies[g], params["adapt_in"][g],
                                    params["adapt_out"][g], h, True)
    for p in unstack(params["tail"], hybrid_lm._n_tail(cfg)):
        h = mamba_lm._block_apply(cfg, p, h, True)
    per_tok, _ = softmax_cross_entropy(transformer.lm_head(cfg, params, h),
                                       batch["labels"])
    return per_tok.mean()


@functools.lru_cache(maxsize=None)
def _reference_copies(n_layers):
    """(params, per-copy shared gradients) of the reference, as numpy."""
    cfg = reduced(jax_config, ARCH, n_layers)
    params = jax_build(cfg).init(jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in tp.batch(cfg, 0).items()}
    copies = [params["shared"]] * jax_hybrid._n_apps(cfg)
    grads = jax.grad(lambda c: _jax_untied_loss(cfg, params, c, b))(copies)
    tonp = functools.partial(jax.tree.map, np.asarray)
    return tonp(params), [tonp(g) for g in grads]


def _copy(tree):
    """A leaf-for-leaf copy of a nested dict of tensors, each a new leaf of
    autograd."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_shared_block_gradient_per_application_and_as_a_sum(n_layers):
    params_np, ref_copies = _reference_copies(n_layers)
    cfg = reduced(get_config, ARCH, n_layers)
    model = build_model(cfg, device="cpu")              # kernels on, group remat
    params = params_from_jax(params_np)
    batch = batch_to_device(tp.batch(cfg, 0), model.device)
    n_apps = hybrid_lm._n_apps(cfg)

    tied_loss, _, tied = value_and_grad(model.loss, params, batch)
    copies = [_copy(params["shared"]) for _ in range(n_apps)]
    untied_loss = _torch_untied_loss(cfg, params, copies, batch)
    names = [n for n, _ in tp._leaves(copies[0])]
    grads = torch.autograd.grad(untied_loss, [x for c in copies
                                              for _, x in tp._leaves(c)])
    # the untied forward is the tied one, application by application
    np.testing.assert_allclose(untied_loss.item(), tied_loss.item(),
                               rtol=tp.LOSS_RTOL)
    per_copy = [dict(zip(names, grads[g * len(names):(g + 1) * len(names)]))
                for g in range(n_apps)]
    for g, (got, want) in enumerate(zip(per_copy, ref_copies)):
        tp.assert_tree_close(got, dict(tp._leaves(want)), atol=tp.GRAD_ATOL,
                             rtol=tp.GRAD_RTOL, norm_rtol=tp.GRAD_NORM_RTOL,
                             what=f"application {g}")
        # every application contributes to the attention weights
        for name in ("attn.wq", "attn.wk", "attn.wv", "attn.wo"):
            assert got[name].abs().sum() > 0, (g, name)
    summed = {name: sum(c[name] for c in per_copy) for name in per_copy[0]}
    tp.assert_tree_close(summed, dict(tp._leaves(tied["shared"])),
                         atol=tp.GRAD_ATOL, rtol=tp.GRAD_RTOL,
                         norm_rtol=tp.GRAD_NORM_RTOL, what="sum vs tied")
    ref_sum = {name: sum(dict(tp._leaves(c))[name] for c in ref_copies)
               for name in per_copy[0]}
    tp.assert_tree_close(tied["shared"], ref_sum, atol=tp.GRAD_ATOL,
                         rtol=tp.GRAD_RTOL, norm_rtol=tp.GRAD_NORM_RTOL,
                         what="tied vs the reference's sum")


def _tree_spec(tree, path=()):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_spec(v, path + (k,)))
        return out
    return {".".join(path): (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_params_from_jax_keeps_the_two_level_stack_and_the_tail(n_layers):
    """The reference's tree (``groups`` (n_apps, k, ...), ``tail`` (n_tail,
    ...), possibly empty) converts leaf for leaf and back, and the port's
    own ``init`` draws the same tree."""
    params_np = _reference_copies(n_layers)[0]
    cfg = reduced(get_config, ARCH, n_layers)
    params = params_from_jax(params_np)
    n_apps, n_tail = hybrid_lm._n_apps(cfg), hybrid_lm._n_tail(cfg)
    assert n_tail == (0 if n_layers is None else 1)
    assert params["groups"]["ssm"]["in_proj"].shape[:2] == (n_apps, 2)
    assert params["tail"]["ln"].shape == (n_tail, cfg.d_model)
    assert params["adapt_in"].shape == (n_apps, cfg.d_model, cfg.d_model)
    back = params_to_numpy(params)
    spec = _tree_spec(params_np)
    assert _tree_spec(back) == spec
    for name, leaf in tp._leaves(params_np):
        np.testing.assert_array_equal(dict(tp._leaves(back))[name], leaf)
    own = hybrid_lm.init(cfg, torch.Generator().manual_seed(0))
    assert _tree_spec(own) == spec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", [None, 5, 81])
def test_init_cache_paths_shapes_and_dtypes_match_reference(n_layers, dtype):
    """At the reduced depths and at zamba2-7b's full config (81 layers: 13
    applications, a tail of 3), on the meta device and by ``eval_shape``."""
    if n_layers == 81:
        jcfg, cfg = jax_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = (reduced(jax_config, ARCH, n_layers),
                     reduced(get_config, ARCH, n_layers))
    B, S = 3, 40
    ref = jax.eval_shape(lambda: jax_hybrid.init_cache(jcfg, B, S,
                                                       getattr(jnp, dtype)))
    got = hybrid_lm.init_cache(cfg, B, S, getattr(torch, dtype), device="meta")
    assert _tree_spec(got) == _tree_spec(ref)
    assert got["k"].dtype == getattr(torch, dtype)
    assert got["ssm_groups"]["s"].dtype == torch.float32


def test_full_and_training_depths_layout():
    """zamba2-7b: 13 applications of the shared block and a 3-layer tail;
    the 27 layers the card trains: 4 applications and the same tail."""
    cfg = get_config(ARCH)
    assert (hybrid_lm._n_apps(cfg), hybrid_lm._n_tail(cfg)) == (13, 3)
    cut = dataclasses.replace(cfg, n_layers=27)
    assert (hybrid_lm._n_apps(cut), hybrid_lm._n_tail(cut)) == (4, 3)
