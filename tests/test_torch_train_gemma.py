"""The port's training slice against the JAX package: gemma-2b (MQA) and gemma3-12b (local:global pattern, remat per group) (reduced).
See torch_train_parity.py for what each check holds and at what tolerance.
The reference runs its Pallas flash kernels (interpret mode) where
``USE_PALLAS`` says so, else its jnp attention, as its ``fit`` does."""
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCHS = ["gemma-2b", "gemma3-12b"]
USE_PALLAS = {"gemma-2b": False, "gemma3-12b": False}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_gradients_match_reference(arch):
    tp.check_loss_and_grads(arch, USE_PALLAS[arch])


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, n_microbatches, steps):
    tp.check_training(arch, n_microbatches, steps)
