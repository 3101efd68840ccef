"""The port's serving slice against the JAX package: the MoE family,
granite-moe-1b-a400m and qwen3-moe-235b-a22b (reduced; qwen3-moe's untied
``lm_head`` too).  See torch_slice_parity.py for what each check holds and
at what tolerance.  Routing capacity is the published factor on both sides,
taken over the tokens of each call, so the prefill, the full forward and
each decode step route as the reference's do."""
import pytest
import torch

import torch_slice_parity as sp

torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]


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
