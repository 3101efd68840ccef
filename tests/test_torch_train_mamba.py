"""The port's training slice against the JAX package: mamba2-2.7b (reduced).
See torch_train_parity.py for what each check holds and at what tolerance.
The gradients are held against the reference with its Pallas SSD kernel in
interpret mode (``use_pallas=True``); the training steps against its
``make_train_step``, which runs the jnp oracle, as its ``fit`` does."""
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"


def test_loss_metrics_and_gradients_match_reference():
    tp.check_loss_and_grads(ARCH, True)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_train_step_matches_reference(n_microbatches, steps):
    tp.check_training(ARCH, n_microbatches, steps)
