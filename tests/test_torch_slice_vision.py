"""The port's serving slice against the JAX package: the VLM family,
llama-3.2-vision-90b (reduced: 2 groups of 1 self block and 1 gated cross
block over 16 image tokens, 4 heads on 2 KV heads x 16).  See
torch_slice_parity.py for what each check holds and at what tolerance; both
sides run with the cross blocks' tanh gates at 0.5, since at init (0) the
cross blocks add nothing and no comparison would see them.  The cache nests
the self blocks' K/V (n_groups, n_self, ...) beside each cross block's
memory K/V."""
import pytest
import torch

import torch_slice_parity as sp

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"


def test_forward_logits_match_reference():
    sp.check_forward(ARCH)


def test_prefill_f32_cache_matches_reference():
    sp.check_prefill(ARCH)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cache_dtype):
    sp.check_greedy_decode(ARCH, cache_dtype)
