"""The port's serving slice against the JAX package: the audio family,
whisper-medium (reduced: 2 encoder layers over 32 frames, 4 decoder layers,
4 heads on 2 KV heads x 16).  See torch_slice_parity.py for what each check
holds and at what tolerance.  The encoder's self attention is non-causal
and each decoder layer's cross attention runs 80 queries against 32 memory
rows, through the flash kernels' plain versions on the port's side and the
reference's Pallas kernel in interpret mode on its side; the cache adds
each layer's memory K/V, decode reads it through ``decode_cross_attention``
in the cache's dtype."""
import pytest
import torch

import torch_slice_parity as sp

torch.set_num_threads(1)

ARCH = "whisper-medium"


def test_forward_logits_match_reference():
    sp.check_forward(ARCH)


def test_prefill_f32_cache_matches_reference():
    sp.check_prefill(ARCH)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cache_dtype):
    sp.check_greedy_decode(ARCH, cache_dtype)
