"""The port's training slice against the JAX package: the audio family,
whisper-medium (reduced: 2 encoder layers over 32 frames, 4 decoder
layers).  See torch_train_parity.py for what each check holds and at what
tolerance.  The gradients are held against the reference with its Pallas
attention in interpret mode (``use_pallas=True``): the encoder's
non-causal self attention, the decoder's causal one, and the cross
attention of 80 queries over 32 memory rows, whose K/V gradient sums into
the encoder's output across the 4 decoder layers' checkpoints.  The
training steps run against the reference's ``make_train_step`` (its jnp
attention) on batches that carry ``frames``, since neither package's
``fit`` makes them."""
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCH = "whisper-medium"


def test_loss_metrics_and_gradients_match_reference():
    tp.check_loss_and_grads(ARCH, True)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_train_step_matches_reference(n_microbatches, steps):
    tp.check_training(ARCH, n_microbatches, steps)
