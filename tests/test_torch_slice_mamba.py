"""The port's serving slice against the JAX package: mamba2-2.7b (reduced).
See torch_slice_parity.py for what each check holds and at what tolerance;
the SSM state is f32, so greedy decode runs with the f32 state only."""
import torch

import torch_slice_parity as sp

torch.set_num_threads(1)

ARCH = "mamba2-2.7b"


def test_forward_logits_match_reference():
    sp.check_forward(ARCH)


def test_prefill_states_match_reference():
    sp.check_prefill(ARCH)


def test_greedy_decode_matches_reference():
    sp.check_greedy_decode(ARCH, "float32")
