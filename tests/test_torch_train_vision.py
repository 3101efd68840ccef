"""The port's training slice against the JAX package: the VLM family,
llama-3.2-vision-90b (reduced: 2 groups of 1 self block and 1 gated cross
block over 16 image tokens).  See torch_train_parity.py for what each check
holds and at what tolerance.  Both sides run with the cross blocks' gates
at 0.5, so the cross attention and its MLP get gradients.  The gradients
are held against the reference with its Pallas attention in interpret mode
(``use_pallas=True``), the steps against its ``make_train_step`` on batches
that carry ``image_embeds``.  On the card the VLM only serves: 10 of its
layers at full width need ~170 GB of params, gradients and AdamW
moments."""
import pytest
import torch

import torch_train_parity as tp

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"


def test_loss_metrics_and_gradients_match_reference():
    tp.check_loss_and_grads(ARCH, True)


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_train_step_matches_reference(n_microbatches, steps):
    tp.check_training(ARCH, n_microbatches, steps)
