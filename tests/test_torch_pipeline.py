"""The port's microbatch pipeline (``repro_torch.parallel.pipeline``)
against the JAX package's single-pod model, on reduced configs, with the
local transport.  See torch_pipeline_parity.py for the params (the
embedding table rounded to bf16, so the pipeline's bf16 round trip of its
input is exact); ``test_torch_pipeline_step.py`` holds the train step
against the reference's and the distributed transport.

What each check holds, and at what tolerance (all f32):
- the loss and every gradient, unstaged back to the model's layout,
  against the reference's ``model.loss`` and ``jax.grad`` (dense at S = 1
  and 2, ssm, hybrid with and without a tail, vlm at S = 2): loss rtol
  1e-5; each gradient element atol 1e-5 / rtol 1e-3 and each leaf's
  relative norm error 1e-4 (measured at most 4.0e-6: summation order only),
  except the embedding, whose gradient through the input comes back through
  bf16 on the pipeline's side: ``EMBED_GRAD_RTOL`` (2**-7) of its norm
  (measured 1.6e-3).  The hybrid's pad layers and adapters get exactly
  zero gradients;
- MoE: capacity is taken per microbatch, so the pipeline's loss is close to
  the single-pod loss, not equal (the reference's own bound, 0.1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jax_build
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.parallel.pipeline import (
    DistributedTransport, LocalTransport,
)
from repro_torch.parallel.staging import unstage

import torch_pipeline_parity as pp

torch.set_num_threads(1)

MOE_LOSS_ATOL = 0.1

GRAD_CASES = [("gpt-2b", None, 1), ("gpt-2b", None, 2), ("gemma3-12b", None, 2),
              ("mamba2-2.7b", None, 2), ("zamba2-7b", None, 2),
              ("zamba2-7b", 7, 2), ("llama-3.2-vision-90b", None, 2)]


@pytest.mark.parametrize("arch,n_layers,S", GRAD_CASES)
def test_local_pipeline_matches_reference_loss_and_grads(arch, n_layers, S):
    jcfg, tcfg = pp.configs(arch, n_layers)
    pn = pp.reference_params(arch, n_layers)
    b = pp.batch(jcfg)
    model = jax_build(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, pn), {k: jnp.asarray(v) for k, v in b.items()})
    st, t_loss, metrics, t_grads = pp.pipeline_grads(
        tcfg, params_from_jax(pn), S, b)
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=pp.LOSS_RTOL)
    assert metrics["tokens"].item() == pp.B * pp.T
    assert metrics["aux_loss"].item() == 0.0
    pp.assert_close(unstage(tcfg, t_grads["staged"], t_grads["shared"]), grads,
                  atol=pp.GRAD_ATOL, rtol=pp.GRAD_RTOL, norm_rtol=pp.GRAD_NORM_RTOL,
                  what="grad", through_bf16=("embed",))
    if tcfg.family == "hybrid" and n_layers == 7:
        # unit 3 (stage 1, unit 1) holds the tail layer and one pad layer
        for k, g in pp.items(t_grads["staged"]["units"]).items():
            assert not g[1, 1, 1].any(), k
        for k in ("adapt_in", "adapt_out"):
            assert not t_grads["staged"][k][1, 1].any(), k


def test_moe_pipeline_is_close_to_its_single_pod_loss():
    jcfg, tcfg = pp.configs("granite-moe-1b-a400m")
    params = params_from_jax(pp.reference_params("granite-moe-1b-a400m"))
    b = pp.batch(jcfg)
    single, _ = build_model(tcfg, device="cpu").loss(
        params, {k: torch.as_tensor(v) for k, v in b.items()})
    _, loss, metrics, grads = pp.pipeline_grads(tcfg, params, 2, b)
    assert abs(loss.item() - single.item()) < MOE_LOSS_ATOL
    assert metrics["aux_loss"].item() > 0
    assert grads["staged"]["blocks"]["moe"]["router"].abs().sum() > 0


def test_distributed_transport_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="not initialised"):
        DistributedTransport()


def test_local_transport_shift_sends_zeros_into_the_first_stage():
    carries = [{"h": torch.full((2,), float(s + 1))} for s in range(3)]
    out = LocalTransport().shift(carries)
    assert [c["h"].tolist() for c in out] == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0]]
