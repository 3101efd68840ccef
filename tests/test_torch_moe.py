"""The port's MoE block (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the same seeded inputs, at the reduced sizes (4
experts, top-2, d 64, ff 128, swiglu).

Both sides route in f32 and sum in other orders only, so:
- expert ids and the kept mask: exactly (the reference's ids and mask are
  recomputed here from its own ops: ``linear``, ``softmax``, ``top_k`` and
  the k-major exclusive cumsum of ``moe_block``);
- the block's output: atol 1e-5; the aux loss: rtol 1e-5;
- gradients of the router, the experts and ``h``: atol 1e-5, rtol 1e-3.
Held at the published capacity factor (1.25) and at 0.25, where experts
overflow and assignments drop (asserted).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro.models import moe_lm as jmoe_lm
from repro.models.common import linear as jlinear
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import moe, moe_lm

torch.set_num_threads(1)

ARCH = "granite-moe-1b-a400m"
B, T = 4, 32
OUT_ATOL, AUX_RTOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-3
FACTORS = [1.25, 0.25]


def _cfg(factor):
    return dataclasses.replace(jax_config(ARCH).reduced(), capacity_factor=factor)


def _inputs(cfg, seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff,
                      cfg.n_experts, cfg.activation)
    p = jax.tree.map(np.array, p)             # writable copies
    h = np.random.default_rng(seed + 1).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    return p, h


def _kw(cfg):
    return dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                activation=cfg.activation, router_aux_coef=cfg.router_aux_coef)


def _reference_routing(p, h, cfg):
    """Expert ids (N, k) and the kept mask (k*N,), from the reference's own
    ops, in ``moe_block``'s order."""
    x = jnp.asarray(h).reshape(-1, cfg.d_model)
    E = cfg.n_experts
    C = jmoe._capacity(x.shape[0], E, cfg.top_k, cfg.capacity_factor)
    probs = jax.nn.softmax(jlinear(x.astype(jnp.float32), jnp.asarray(p["router"])),
                           axis=-1)
    _, expert_ids = jax.lax.top_k(probs, cfg.top_k)
    flat_e = expert_ids.T.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(expert_ids), np.asarray(pos < C), C


def _port_routing(p, h, cfg):
    x = torch.from_numpy(h).reshape(-1, cfg.d_model)
    C = moe._capacity(x.shape[0], cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    _, _, expert_ids = moe.route(torch.from_numpy(p["router"]), x, cfg.top_k)
    _, pos_c, keep = moe.positions(expert_ids, cfg.n_experts, C)
    return expert_ids.numpy(), keep.numpy(), pos_c.numpy(), C


@pytest.mark.parametrize("factor", FACTORS)
def test_routing_matches_reference_exactly(factor):
    cfg = _cfg(factor)
    p, h = _inputs(cfg)
    ref_ids, ref_keep, ref_C = _reference_routing(p, h, cfg)
    ids, keep, pos_c, C = _port_routing(p, h, cfg)
    assert C == ref_C
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(keep, ref_keep)
    assert (pos_c[~keep] == C).all() and (pos_c[keep] < C).all()
    if factor < 1:
        assert not keep.all(), "capacity 0.25 must drop assignments"
    else:
        assert keep.all()


@pytest.mark.parametrize("factor", FACTORS)
def test_moe_block_matches_reference(factor):
    cfg = _cfg(factor)
    p, h = _inputs(cfg)
    ref_out, ref_aux = jmoe.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(h),
                                      **_kw(cfg))
    out, aux = moe.moe_block(params_from_jax(p), torch.from_numpy(h), **_kw(cfg))
    assert out.shape == (B, T, cfg.d_model) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=OUT_ATOL,
                               rtol=0)
    assert float(ref_aux) > 0
    np.testing.assert_allclose(aux.item(), float(ref_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("factor", FACTORS)
def test_moe_block_gradients_match_reference(factor):
    """d(sum(out * g) + aux) / d(router, experts, h) for a fixed cotangent g."""
    cfg = _cfg(factor)
    p, h = _inputs(cfg)
    g = np.random.default_rng(7).standard_normal(h.shape).astype(np.float32)

    def ref_obj(pp, hh):
        out, aux = jmoe.moe_block(pp, hh, **_kw(cfg))
        return jnp.sum(out * jnp.asarray(g)) + aux
    ref_gp, ref_gh = jax.grad(ref_obj, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(h))

    tp = {k: v.requires_grad_() for k, v in params_from_jax(p).items()}
    th = torch.from_numpy(h).requires_grad_()
    out, aux = moe.moe_block(tp, th, **_kw(cfg))
    (out * torch.from_numpy(g)).sum().add(aux).backward()
    assert sorted(tp) == sorted(ref_gp)
    for name, leaf in tp.items():
        assert leaf.grad is not None and leaf.grad.abs().sum() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref_gp[name]),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(ref_gh),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg="h")


def test_dropped_assignments_get_no_output_and_no_gradient():
    """A token whose every choice overflows reads zeros and sends no
    gradient back to its row of ``h``."""
    cfg = _cfg(0.25)
    p, h = _inputs(cfg)
    ids, keep, _, _ = _port_routing(p, h, cfg)
    dropped = ~keep.reshape(cfg.top_k, -1).any(axis=0)      # tokens, all k dropped
    assert dropped.any()
    th = torch.from_numpy(h).requires_grad_()
    out, _ = moe.moe_block(params_from_jax(p), th, **_kw(cfg))
    out.sum().backward()
    rows = torch.from_numpy(dropped)
    assert out.reshape(-1, cfg.d_model)[rows].abs().max().item() == 0.0
    assert th.grad.reshape(-1, cfg.d_model)[rows].abs().max().item() == 0.0


def test_positions_are_k_major_then_token_order():
    """Every token's first choice is placed before any second choice."""
    ids = torch.tensor([[0, 1], [0, 2], [1, 0], [0, 1]])
    flat_e, pos_c, keep = moe.positions(ids, 3, 2)
    # k = 0: experts 0, 0, 1, 0 -> slots 0, 1, 0, (2: dropped)
    # k = 1: experts 1, 2, 0, 1 -> slots 1, 0, (2: dropped), (2: dropped)
    assert flat_e.tolist() == [0, 0, 1, 0, 1, 2, 0, 1]
    assert pos_c.tolist() == [0, 1, 0, 2, 1, 0, 2, 2]
    assert keep.tolist() == [True, True, True, False, True, True, False, False]


def test_equal_probabilities_pick_the_lower_expert_first():
    """A zero router gives every expert the same probability: the reference's
    ``top_k`` then picks experts 0 .. k-1 in order, and so must the port."""
    cfg = _cfg(1.25)
    p, h = _inputs(cfg)
    p = dict(p, router=np.zeros_like(p["router"]))
    ref_ids, ref_keep, _ = _reference_routing(p, h, cfg)
    ids, keep, _, _ = _port_routing(p, h, cfg)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(ids, np.tile(np.arange(cfg.top_k), (B * T, 1)))
    np.testing.assert_array_equal(keep, ref_keep)
    ref_out, _ = jmoe.moe_block(jax.tree.map(jnp.asarray, p), jnp.asarray(h),
                                **_kw(cfg))
    out, _ = moe.moe_block(params_from_jax(p), torch.from_numpy(h), **_kw(cfg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=OUT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("n_tokens,n_experts,top_k,factor", [
    (8, 32, 8, 1.25), (8, 32, 8, 4.0), (4096, 32, 8, 1.25), (8192, 32, 8, 1.25),
    (8192, 32, 8, 4.0), (128, 4, 2, 1.25), (128, 4, 2, 0.25), (3, 4, 2, 8.0),
])
def test_capacity_matches_reference(n_tokens, n_experts, top_k, factor):
    assert (moe._capacity(n_tokens, n_experts, top_k, factor)
            == jmoe._capacity(n_tokens, n_experts, top_k, factor))


def test_block_has_no_data_dependent_shape():
    """The block runs on the meta device, where a shape read from the data
    (``nonzero``, boolean indexing, ``.item()``) cannot be computed."""
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.activation)
    p = {k: v.to("meta") for k, v in p.items()}
    out, aux = moe.moe_block(p, torch.empty(B, T, cfg.d_model, device="meta"),
                             top_k=cfg.top_k, capacity_factor=0.25,
                             activation=cfg.activation, router_aux_coef=0.01)
    assert out.shape == (B, T, cfg.d_model) and aux.shape == ()


@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-235b-a22b"])
def test_params_from_jax_keeps_stacked_experts_and_f32_router(arch):
    """The reference's bf16 init: experts stacked (L, E, d, ff) in bf16, the
    router (L, d, E) in f32; ``params_from_jax`` keeps every shape and dtype,
    and the port's own init has the same tree."""
    jcfg = jax_config(arch).reduced()
    ref = jax.tree.map(np.asarray, jmoe_lm.init(jcfg, jax.random.PRNGKey(0),
                                                dtype=jnp.bfloat16))
    got = params_from_jax(ref)
    cfg = get_config(arch).reduced()
    own = moe_lm.init(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    L, E, d, ff = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    blk = got["blocks"]["moe"]
    assert blk["router"].dtype == torch.float32
    assert tuple(blk["router"].shape) == (L, d, E)
    for name, shape in (("w_up", (L, E, d, ff)), ("w_gate", (L, E, d, ff)),
                        ("w_down", (L, E, ff, d))):
        assert blk[name].dtype == torch.bfloat16, name
        assert tuple(blk[name].shape) == shape, name
        # bf16 bits through numpy unchanged
        assert np.array_equal(blk[name].view(torch.int16).numpy(),
                              ref["blocks"]["moe"][name].view(np.int16)), name

    def tree(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from tree(t[k], path + (k,))
        else:
            yield path, tuple(t.shape), str(t.dtype).split(".")[-1]
    assert list(tree(own)) == list(tree(got))
    assert ("lm_head" in got) == (not cfg.tie_embeddings)
