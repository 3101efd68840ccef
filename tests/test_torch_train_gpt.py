"""The port's training slice against the JAX package: gpt-2b and minitron-8b (reduced).
See torch_train_parity.py for what each check holds and at what tolerance.
The reference runs its Pallas flash kernels (interpret mode) where
``USE_PALLAS`` says so, else its jnp attention, as its ``fit`` does."""
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCHS = ["gpt-2b", "minitron-8b"]
USE_PALLAS = {"gpt-2b": True, "minitron-8b": False}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_gradients_match_reference(arch):
    tp.check_loss_and_grads(arch, USE_PALLAS[arch])


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, n_microbatches, steps):
    tp.check_training(arch, n_microbatches, steps)


def test_value_and_grad_raises_on_a_leaf_the_loss_does_not_reach():
    """A leaf cut off from autograd (as a kernel output without a grad_fn
    would cut off wq/wk/wv) raises instead of training on zero gradients."""
    from repro_torch.train.step import value_and_grad
    params = {"w": torch.ones(3), "cut": torch.ones(3)}

    def loss_fn(p, batch):
        return (p["w"] * batch["x"] + p["cut"].detach()).sum(), {}
    with pytest.raises(RuntimeError):
        value_and_grad(loss_fn, params, {"x": torch.ones(3)})
