"""The port's training slice against the JAX package: the hybrid family,
zamba2-7b (reduced, no tail; and its 5-layer variant with a tail of one SSD
layer).  See torch_train_parity.py for what each check holds and at what
tolerance.  The gradients are held against the reference with its Pallas
attention and SSD kernel in interpret mode (``use_pallas=True``), the shared
block's and the adapters' among them; the training steps against its
``make_train_step``, which runs the jnp versions, as its ``fit`` does.
Each group (its SSD blocks and the shared application) is recomputed in
the backward on both sides."""
import numpy as np
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCH = "zamba2-7b"
DEPTHS = [None, 5]


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_loss_metrics_and_gradients_match_reference(n_layers):
    grads = tp.check_loss_and_grads(ARCH, True, n_layers)
    # the tail's SSD layer trains; an empty tail has an empty gradient
    tail = grads["tail"]["ssm"]["in_proj"]
    if n_layers is None:
        assert tail.shape[0] == 0
    else:
        assert tail.shape[0] == 1 and np.abs(tail.numpy()).sum() > 0


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_train_step_matches_reference(n_layers, n_microbatches, steps):
    tp.check_training(ARCH, n_microbatches, steps, n_layers)
