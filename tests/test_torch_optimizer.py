"""AdamW of the port against ``repro.train.optimizer.make_adamw``: the same
tree (1-d norms, a 2-d matrix and stacked 2-d and 3-d leaves), the same
numpy gradients, three updates, with the clip active and inactive,
bfloat16 optimizer state, and bfloat16 params with f32 master weights.

Tolerances.  f32 state: both sides do the same f32 arithmetic in the same
order per element, but the grad norm is a sum in another order and XLA may
fuse a multiply-add; gradients here are O(1), far from the near-zero
elements where AdamW's ``m / (sqrt(v) + eps)`` amplifies a rounding
difference, so params, mu and nu agree to 1e-6 relative (atol 1e-7).
bf16 state and params: both round the same f32 values to bf16, so a value
within a rounding difference of a bf16 boundary lands one bf16 ulp apart
(2**-7 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.optimizer import lr_schedule as jax_lr_schedule
from repro.train.optimizer import make_adamw as jax_make_adamw
from repro_torch.convert import params_from_jax
from repro_torch.train.optimizer import (
    OptimizerConfig, lr_schedule, make_adamw, tree_leaves, tree_unflatten,
)

torch.set_num_threads(1)

SHAPES = {"norm": (16,), "embed": (32, 16),
          "blocks": {"ln": (3, 16), "w": (3, 8, 16)}}
F32_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-7)


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)
    return make(shapes)


def _close(t, j, tol):
    for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)), **tol)


CASES = {
    "clip_inactive": dict(grad_clip=1e3),
    "clip_active": dict(grad_clip=1.0),
    "no_clip": dict(grad_clip=0.0),
    "state_bf16": dict(state_dtype="bfloat16"),
    "master_weights": dict(master_weights=True, param_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_matches_reference(case):
    kw = dict(CASES[case])
    param_dtype = kw.pop("param_dtype", "float32")
    state_dtype = kw.pop("state_dtype", "float32")
    common = dict(lr=1e-2, warmup_steps=2, total_steps=5, **kw)
    jcfg = JaxOptimizerConfig(state_dtype=getattr(jnp, state_dtype), **common)
    tcfg = OptimizerConfig(state_dtype=getattr(torch, state_dtype), **common)
    jinit, jupdate = jax_make_adamw(jcfg)
    tinit, tupdate = make_adamw(tcfg)

    p0 = _tree(0, 0.1)
    jp = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, param_dtype)), p0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    js, ts = jinit(jp), tinit(tp)
    for i in range(3):
        g = _tree(10 + i, 3.0)                  # global norm ~ 3 * sqrt(752)
        jg = jax.tree.map(lambda x: jnp.asarray(x, getattr(jnp, param_dtype)), g)
        tg = params_from_jax(jax.tree.map(np.asarray, jg))
        jp, js, jm = jupdate(jg, js, jp)
        tp, ts, tm = tupdate(tg, ts, tp)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-7)
    assert int(ts.step) == int(js.step) == 3
    state_tol = F32_TOL if state_dtype == "float32" else BF16_TOL
    _close(ts.mu, js.mu, state_tol)
    _close(ts.nu, js.nu, state_tol)
    assert all(x.dtype == getattr(torch, state_dtype) for x in tree_leaves(ts.mu))
    if kw.get("master_weights"):
        _close(ts.master, js.master, F32_TOL)
        assert all(x.dtype == torch.float32 for x in tree_leaves(ts.master))
    else:
        assert ts.master is None and js.master is None
    _close(tp, jp, F32_TOL if param_dtype == "float32" else BF16_TOL)
    assert all(x.dtype == getattr(torch, param_dtype) for x in tree_leaves(tp))


def test_update_is_in_place_and_skips_decay_on_vectors():
    """The returned params and state are the tensors passed in; with zero
    gradients only weight decay moves params, and only leaves of ndim >= 2."""
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    init, update = make_adamw(cfg)
    params = params_from_jax(_tree(1))
    before = {id(x): x.clone() for x in tree_leaves(params)}
    state = init(params)
    mu0 = tree_leaves(state.mu)
    zeros = tree_unflatten(params, [torch.zeros_like(x) for x in tree_leaves(params)])
    new_p, new_s, m = update(zeros, state, params)
    assert new_p is params and new_s is state
    assert all(a is b for a, b in zip(tree_leaves(new_s.mu), mu0))
    for x in tree_leaves(params):
        moved = not torch.equal(x, before[id(x)])
        assert moved == (x.dim() >= 2)
    assert m["grad_norm"].item() == 0.0


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=20, total_steps=100, min_lr_frac=0.1)
    for step in [0, 1, 5, 19, 20, 21, 50, 99, 100, 150]:
        t = lr_schedule(OptimizerConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        j = jax_lr_schedule(JaxOptimizerConfig(**cfg), jnp.int32(step))
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.item(), float(j), rtol=1e-7)
