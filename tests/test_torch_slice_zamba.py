"""The port's serving slice against the JAX package: the hybrid family,
zamba2-7b (reduced: 4 SSD layers, the shared block every 2, so 2
applications and no tail; and its 5-layer variant, whose tail holds one SSD
layer).  See torch_slice_parity.py for what each check holds and at what
tolerance.  The cache nests the SSD states (``ssm_groups`` / ``ssm_tail``,
f32) beside the shared block's K/V (the cache dtype), compared by path."""
import pytest
import torch

import torch_slice_parity as sp

torch.set_num_threads(1)

ARCH = "zamba2-7b"
DEPTHS = [None, 5]        # reduced (no tail), and a tail of one layer


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_forward_logits_match_reference(n_layers):
    sp.check_forward(ARCH, n_layers)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_prefill_f32_cache_matches_reference(n_layers):
    sp.check_prefill(ARCH, n_layers)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_greedy_decode_matches_reference(n_layers, cache_dtype):
    sp.check_greedy_decode(ARCH, cache_dtype, n_layers)
