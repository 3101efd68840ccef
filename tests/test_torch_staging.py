"""The port's pipeline staging (``repro_torch.parallel.staging``) and its
partition rules (``repro_torch.parallel.sharding``) against the JAX
package's, for every pipelined family.  See torch_pipeline_parity.py for the
cases and the params; ``test_torch_stage_fns.py`` holds the slot functions.

What each check holds:
- ``staged`` / ``shared`` / ``consts``: leaf for leaf, exactly (the
  restructuring is reshape, concatenation and zero padding), at S = 1 and
  2, and ``unstage`` gives the model's layout back exactly;
- at full width, for every registered arch of a pipelined family: staging
  ``meta`` tensors shaped like ``jax.eval_shape(model.init)`` gives the
  reference's shapes and dtypes at S = 2, with no memory;
- the partition rules: the port's spec tuples equal the reference's
  ``PartitionSpec``s for every arch's full-width params, staged too;
- audio raises the reference's ``ValueError``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.parallel import sharding as jax_shd
from repro.parallel.staging import build_staging as jax_staging
from repro.train.step import pipeline_shardings as jax_pipeline_shardings
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.staging import build_staging, unstage
from repro_torch.train.step import pipeline_shardings

import torch_pipeline_parity as pp

torch.set_num_threads(1)

PIPELINED = ("dense", "moe", "ssm", "hybrid", "vlm")


def _stagings(arch, n_layers, S, dtype="float32"):
    jcfg, tcfg = pp.configs(arch, n_layers)
    pn = pp.reference_params(arch, n_layers)
    js = jax_staging(jcfg, S, jax.tree.map(jnp.asarray, pn),
                     act_dtype=getattr(jnp, dtype))
    ts = build_staging(tcfg, S, params_from_jax(pn),
                       act_dtype=getattr(torch, dtype))
    return jcfg, tcfg, js, ts


def _assert_trees_equal(port, ref):
    port, ref = pp.items(port), pp.items(ref)
    assert sorted(port) == sorted(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        assert tuple(port[k].shape) == r.shape, k
        assert str(port[k].dtype).split(".")[-1] == str(r.dtype), k
        np.testing.assert_array_equal(pp.np32(port[k]), r.astype(np.float32),
                                      err_msg=k)


@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("arch,n_layers", pp.CASES, ids=pp.IDS)
def test_staged_shared_consts_equal_reference(arch, n_layers, S):
    _, tcfg, js, ts = _stagings(arch, n_layers, S)
    _assert_trees_equal(ts.staged, js.staged)
    _assert_trees_equal(ts.shared, js.shared)
    _assert_trees_equal(ts.consts, js.consts)
    # and back: unstaging gives the model's layout (the hybrid's pad dropped)
    back = pp.items(unstage(tcfg, ts.staged, ts.shared))
    want = pp.items(params_from_jax(pp.reference_params(arch, n_layers)))
    assert sorted(back) == sorted(want)
    for k in want:
        assert torch.equal(back[k], want[k]), k


def test_audio_is_not_pipelined_as_in_the_reference():
    jcfg, tcfg = pp.configs("whisper-medium")
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as ref:
        jax_staging(jcfg, 2, jparams)
    with pytest.raises(ValueError) as port:
        build_staging(tcfg, 2, params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert str(port.value) == str(ref.value)


def _full_width(arch):
    """(reference config, port config, eval_shape tree, meta tensor tree)."""
    jcfg = jax_config(arch)
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))

    def meta(s):
        return torch.empty(s.shape, dtype=getattr(torch, str(s.dtype)),
                           device="meta")
    return jcfg, get_config(arch), shapes, jax.tree.map(meta, shapes)


def _assert_same_shapes(port, ref):
    port, ref = pp.items(port), pp.items(ref)
    assert sorted(port) == sorted(ref)
    for k, r in ref.items():
        assert port[k].device.type == "meta", k
        assert (tuple(port[k].shape), str(port[k].dtype).split(".")[-1]) == \
            (tuple(r.shape), str(r.dtype)), k


PIPELINED_ARCHS = [a for a in list_archs() if get_config(a).family in PIPELINED]


@pytest.mark.parametrize("arch", PIPELINED_ARCHS)
def test_full_width_staging_on_meta_matches_reference_shapes(arch):
    jcfg, tcfg, shapes, meta = _full_width(arch)
    js = jax_staging(jcfg, 2, shapes)
    ts = build_staging(tcfg, 2, meta)
    _assert_same_shapes(ts.staged, js.staged)
    _assert_same_shapes(ts.shared, js.shared)
    _assert_same_shapes(ts.consts, js.consts)
    # the staged specs of the full-width staging, against the reference's
    port = pp.items(shd.staged_param_pspecs(ts.staged))
    ref = pp.items(jax_shd.staged_param_pspecs(js.staged))
    assert port == {k: tuple(v) for k, v in ref.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_reference(arch):
    _, _, shapes, meta = _full_width(arch)
    ref = jax.tree_util.tree_flatten_with_path(
        jax_shd.param_pspecs(shapes), is_leaf=lambda x: isinstance(x, tuple))[0]
    ref = {".".join(k.key for k in path): tuple(spec) for path, spec in ref}
    assert pp.items(shd.param_pspecs(meta)) == ref


def test_pipeline_shardings_equal_reference_specs():
    jcfg, tcfg, shapes, meta = _full_width("gpt-2b")
    js = jax_staging(jcfg, 2, shapes)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    ref = jax_pipeline_shardings(js, mesh)
    port = pipeline_shardings(build_staging(tcfg, 2, meta))
    assert sorted(port) == ["consts", "shared", "staged"]
    for name in port:
        want = {k: tuple(v) for k, v in pp.items(
            jax.tree.map(lambda s: s, ref[f"{name}_specs"],
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        ).items()}
        assert pp.items(port[name]) == want, name
    assert pp.items(port["consts"]) == {"first": ("pod", None)}


def test_train_act_rules_equal_reference():
    for multi_pod in (False, True):
        assert shd.train_act_rules() == jax_shd.train_act_rules(multi_pod)


def test_rules_reject_an_unknown_leaf_as_the_reference_does():
    with pytest.raises(KeyError, match="no sharding rule for param blocks/w_new"):
        shd.param_pspecs({"blocks": {"w_new": torch.empty(2, 3, device="meta")}})
    with pytest.raises(KeyError, match="no sharding rule for param blocks/w_new"):
        jax_shd.param_pspecs({"blocks": {"w_new": jnp.zeros((2, 3))}})


def test_zamba2_tail_pads_to_zero_gated_units():
    """81 = 13 x 6 + 3 at full width: 14 units, the last holding the 3 tail
    layers and 3 pad layers; the reduced 7-layer form: 4 units of 2."""
    _, tcfg, _, meta = _full_width("zamba2-7b")
    st = build_staging(tcfg, 2, meta)
    assert st.staged["units"]["ln"].shape[:3] == (2, 7, 6)
    _, tcfg, _, ts = _stagings("zamba2-7b", 7, 2)
    np.testing.assert_array_equal(ts.consts["ssm_gate"].reshape(4, 2).numpy(),
                                  [[1, 1], [1, 1], [1, 1], [1, 0]])
    np.testing.assert_array_equal(ts.consts["app_gate"].reshape(4).numpy(),
                                  [1, 1, 1, 0])
    # (stage, unit, layer): the last unit's second layer and its adapters
    # are the pad
    assert not ts.staged["units"]["ssm"]["in_proj"][1, 1, 1].any()
    assert ts.staged["units"]["ssm"]["in_proj"][1, 1, 0].any()
    assert not ts.staged["adapt_in"][1, 1].any()
    assert not ts.staged["adapt_out"][1, 1].any()


@pytest.mark.parametrize("arch,n_layers", pp.CASES, ids=pp.IDS)
def test_staging_shares_the_params_storage(arch, n_layers):
    """``staged`` is a view of the model's stacked leaves (no copy of the
    weights) except where padding concatenates (the hybrid)."""
    _, tcfg = pp.configs(arch, n_layers)
    params = params_from_jax(pp.reference_params(arch, n_layers))
    st = build_staging(tcfg, 2, params)
    assert st.shared["embed"] is params["embed"]
    if tcfg.family in ("dense", "moe", "ssm"):
        for k, v in pp.items(st.staged["blocks"]).items():
            assert v.data_ptr() == pp.items(params["blocks"])[k].data_ptr(), k
    assert unstage(tcfg, st.staged, st.shared).keys() == params.keys()
