"""The port's training slice against the JAX package: the MoE family,
granite-moe-1b-a400m and qwen3-moe-235b-a22b (reduced).  See
torch_train_parity.py for what each check holds and at what tolerance; the
loss carries the layers' router aux losses, held as the ``aux_loss``
metric.  The gradients are held against the reference with its Pallas
attention in interpret mode (``use_pallas=True``); the training steps
against its ``make_train_step``, whose microbatches each route with their
own capacity, as the port's do."""
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_gradients_match_reference(arch):
    tp.check_loss_and_grads(arch, True)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, n_microbatches, steps):
    tp.check_training(arch, n_microbatches, steps)
