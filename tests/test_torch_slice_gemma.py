"""The port's serving slice against the JAX package: gemma-2b and gemma3-12b (reduced).
See torch_slice_parity.py for what each check holds and at what tolerance."""
import pytest
import torch

import torch_slice_parity as sp

torch.set_num_threads(1)

ARCHS = ["gemma-2b", "gemma3-12b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    sp.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_f32_cache_matches_reference(arch):
    sp.check_prefill(arch)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_reference(arch, cache_dtype):
    sp.check_greedy_decode(arch, cache_dtype)
