"""One slot of the port's stage functions against the JAX package's:
``make_io`` (exact: a gather and casts), ``zero_carry`` (exact),
``stage_fn`` for every stage and ``head_loss``, in f32 and in bf16
activations, for every pipelined family at S = 1 and 2.  See
torch_pipeline_parity.py for the cases and the params.

Tolerances.  A stage's output is held to ``STAGE_TOL`` of its largest
magnitude: f32 1e-5 (measured at most 1.4e-6: summation order only), bf16
3e-2 (measured at most 1.3e-2: XLA keeps some elementwise intermediates in
f32 where torch rounds each op to bf16).  In bf16 the MoE router's logits
differ in their last bits and a near-tie can route a token to another
expert, which moves its whole row: at most ``MOE_FLIP_ROWS`` of the rows may
exceed the tolerance (measured 1 of 80); in f32 every row is held.  The
head's CE sum: rtol 1e-5 in f32, 1e-2 in bf16.

The hybrid in bf16: the reference multiplies its bf16 carry by f32 gates,
which promotes the carry to f32, and its ``lax.scan`` then raises.  That
fault is pinned; the port casts the gates to the carry's dtype, and its
bf16 stages are held to the reference's f32 stages on the same bf16-valued
inputs at the bf16 tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel.staging import build_staging as jax_staging
from repro_torch.convert import params_from_jax
from repro_torch.parallel.staging import build_staging
from repro_torch.train.optimizer import tree_map

import torch_pipeline_parity as pp

torch.set_num_threads(1)

STAGE_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
HEAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
MOE_FLIP_ROWS = 0.05


def _stagings(arch, n_layers, S, dtype="float32"):
    jcfg, tcfg = pp.configs(arch, n_layers)
    pn = pp.reference_params(arch, n_layers)
    js = jax_staging(jcfg, S, jax.tree.map(jnp.asarray, pn),
                     act_dtype=getattr(jnp, dtype))
    ts = build_staging(tcfg, S, params_from_jax(pn),
                       act_dtype=getattr(torch, dtype))
    return jcfg, tcfg, js, ts


def _slot_inputs(cfg, dtype, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((pp.B // pp.N_MB, pp.T, cfg.d_model)).astype(np.float32)
    h = np.asarray(jnp.asarray(h).astype(getattr(jnp, dtype)).astype(jnp.float32))
    return h, np.float32(rng.standard_normal())


def _close(port, ref, dtype, family):
    err = np.abs(port - ref).max(axis=-1)
    tol = STAGE_TOL[dtype] * np.abs(ref).max()
    if dtype == "bfloat16" and family == "moe":
        assert (err > tol).mean() <= MOE_FLIP_ROWS, ((err > tol).mean(), err.max())
    else:
        assert err.max() <= tol, (err.max(), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("arch,n_layers", pp.CASES, ids=pp.IDS)
def test_slot_functions_match_reference(arch, n_layers, S, dtype):
    jcfg, tcfg, js, ts = _stagings(arch, n_layers, S, dtype)
    hybrid_bf16 = jcfg.family == "hybrid" and dtype == "bfloat16"
    if hybrid_bf16:        # the reference's hybrid stages run only in f32
        js = _stagings(arch, n_layers, S)[2]
    b = pp.batch(jcfg)
    jio = js.make_io(js.shared, {k: jnp.asarray(v) for k, v in b.items()}, pp.N_MB)
    tio = ts.make_io(ts.shared, {k: torch.as_tensor(v) for k, v in b.items()},
                     pp.N_MB)
    assert sorted(tio) == sorted(jio)
    for k in jio:
        assert str(tio[k].dtype).split(".")[-1] == (
            dtype if k in ("h_in", "img") else "int64"), k
        np.testing.assert_array_equal(pp.np32(tio[k]), pp.np32(jio[k]), err_msg=k)

    jc, tc = js.zero_carry(jio), ts.zero_carry(tio)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape and not tc[k].any(), k
    assert tc["h"].dtype == getattr(torch, dtype)

    def reference_slot(staged1, consts1, carry, io_t, io_out):
        return (js.stage_fn(staged1, consts1, js.shared, carry, io_t),
                js.head_loss(js.shared, carry, io_out))

    reference_slot = jax.jit(reference_slot)
    for s in range(S):
        h, aux = _slot_inputs(jcfg, dtype, seed=10 + s)
        jc = {**jc, "h": jnp.asarray(h).astype(jc["h"].dtype)}
        tc = {**tc, "h": torch.tensor(h).to(tc["h"].dtype)}
        if "aux" in jc:
            jc["aux"], tc["aux"] = jnp.float32(aux), torch.tensor(aux)
        jo, jh = reference_slot(jax.tree.map(lambda x: x[s], js.staged),
                                jax.tree.map(lambda x: x[s], js.consts), jc,
                                jax.tree.map(lambda a: a[1], jio),
                                jax.tree.map(lambda a: a[0], jio))
        to = ts.stage_fn(tree_map(lambda x: x[s], ts.staged),
                         tree_map(lambda x: x[s], ts.consts), ts.shared, tc,
                         {k: v[1] for k, v in tio.items()})
        assert sorted(to) == sorted(jo)
        assert to["h"].dtype == getattr(torch, dtype)
        _close(pp.np32(to["h"]), pp.np32(jo["h"]), dtype, jcfg.family)
        if "aux" in jo:
            np.testing.assert_allclose(to["aux"].item(), float(jo["aux"]),
                                       rtol=1e-5 if dtype == "float32" else 0.05)

        th = ts.head_loss(ts.shared, tc, {k: v[0] for k, v in tio.items()})
        np.testing.assert_allclose(th[0].item(), float(jh[0]), rtol=HEAD_RTOL[dtype])
        assert th[1].item() == float(jh[1]) == pp.B // pp.N_MB * pp.T
        assert th[2].item() == pytest.approx(float(jh[2]), rel=1e-6)
        assert all(x.dtype == torch.float32 for x in th)


@pytest.mark.parametrize("n_layers", [None, 7])
def test_reference_hybrid_stage_rejects_bf16_and_the_port_runs_it(n_layers):
    """The reference's gates are f32: ``c + g * delta`` promotes the bf16
    carry to f32 and ``lax.scan`` rejects the changed carry dtype."""
    jcfg, tcfg, js, ts = _stagings("zamba2-7b", n_layers, 2, "bfloat16")
    b = pp.batch(jcfg)
    jio = js.make_io(js.shared, {k: jnp.asarray(v) for k, v in b.items()}, pp.N_MB)
    with pytest.raises(TypeError, match="dtypes do not match"):
        js.stage_fn(jax.tree.map(lambda x: x[0], js.staged),
                    jax.tree.map(lambda x: x[0], js.consts), js.shared,
                    js.zero_carry(jio), jax.tree.map(lambda a: a[0], jio))
    tio = ts.make_io(ts.shared, {k: torch.as_tensor(v) for k, v in b.items()},
                     pp.N_MB)
    out = ts.stage_fn(tree_map(lambda x: x[0], ts.staged),
                      tree_map(lambda x: x[0], ts.consts), ts.shared,
                      ts.zero_carry(tio), {k: v[0] for k, v in tio.items()})
    assert out["h"].dtype == torch.bfloat16 and bool(torch.isfinite(out["h"]).all())
