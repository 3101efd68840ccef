"""The port's CUDA kernels against their plain PyTorch versions, on a Hopper
card only (marker ``cuda_sm90``; every test skips without one).  This file
imports neither jax nor the reference package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_fwd,
)
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

torch.set_num_threads(1)

# the reference's kernel-test tolerances: f32 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# gradients: the reference's f32 gradient tolerance (atol 5e-5, rtol 1e-3).
# bf16: both sides sum in f32 in other orders and round once to bf16, so an
# element near a rounding boundary lands one bf16 ulp apart and no further;
# rtol 8e-3 is above one ulp (at most 2**-7 relative), atol 4e-3 is one ulp
# of an element in [0.5, 1) and covers the small ones
GRAD_TOL = {"float32": (5e-5, 1e-3), "bfloat16": (4e-3, 8e-3)}

# (B, T, S, H, KV, D, causal, window)
KERNEL_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),      # the reference's FLASH_CASES
    (2, 200, 200, 8, 2, 64, True, 0),
    (1, 256, 256, 4, 1, 32, True, 64),
    (2, 64, 192, 2, 2, 64, False, 0),
    (1, 130, 130, 2, 2, 128, True, 0),
    (8, 512, 512, 32, 32, 80, True, 0),    # gpt-2b prefill
    (8, 1024, 1024, 32, 32, 80, True, 0),  # gpt-2b training
    (2, 512, 512, 8, 1, 256, True, 0),     # gemma-2b: MQA, D = 256
    (2, 300, 300, 4, 4, 112, True, 0),     # zamba2's D = 112
    (1, 100, 40, 2, 1, 80, True, 16),      # fully masked rows (Tq > Tk)
]


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card of compute capability >= 9.0 (Hopper)")
    return torch.device("cuda")


def _qkv(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_version(hopper, case, dtype):
    B, T, S, H, KV, D, causal, window = case
    q, k, v = (torch.from_numpy(x).to(hopper, getattr(torch, dtype))
               for x in _qkv(5, B, T, S, H, KV, D))
    before = LAUNCHES["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd"] == before + 1
    ro, rl = flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert torch.equal(torch.isneginf(lse), torch.isneginf(rl))
    fin = torch.isfinite(rl)
    torch.testing.assert_close(lse[fin], rl[fin], atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda_sm90
def test_flash_kernel_reads_strided_model_layout(hopper):
    """q/k/v as views of one fused projection: strided, no copies."""
    B, T, H, D = 2, 96, 4, 80
    qkv = torch.randn(B, T, 3, H, D, device=hopper)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    ro, rl = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ro, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(lse, rl, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda_sm90
def test_flash_kernel_rejects_a_launch_it_cannot_make(hopper):
    q = torch.randn(1, 8, 2, 256, device=hopper)
    with pytest.raises(RuntimeError, match="CUDA error"):
        # 1024 keys of 256 f32 values per tile: more shared memory than a block has
        flash_attention_fwd(q, q, q, causal=True, block_k=1024)


def _grads_close(got, want, dtype):
    atol, rtol = GRAD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_version(hopper, case, dtype):
    B, T, S, H, KV, D, causal, window = case
    q, k, v = (torch.from_numpy(x).to(hopper, getattr(torch, dtype))
               for x in _qkv(6, B, T, S, H, KV, D))
    do = torch.from_numpy(_qkv(7, B, T, S, H, KV, D)[0]).to(hopper, q.dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd_dq"] == before["flash_attention_bwd_dq"] + 1
    assert LAUNCHES["flash_attention_bwd_dkv"] == before["flash_attention_bwd_dkv"] + 1
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    _grads_close(got, want, dtype)


@pytest.mark.cuda_sm90
def test_flash_bwd_kernels_read_strided_model_layout(hopper):
    """q/k/v as views of one fused projection, and the expanded (stride 0)
    gradient of a sum."""
    B, T, H, D = 2, 96, 4, 80
    qkv = torch.randn(B, T, 3, H, D, device=hopper)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    for do in (torch.randn(B, T, H, D, device=hopper),
               torch.ones((), device=hopper).expand(B, T, H, D)):
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True)
        _grads_close(got, want, "float32")


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", KERNEL_CASES[:5])
def test_flash_attention_gradients_flow_through_the_kernels(hopper, case):
    """ops.flash_attention is differentiable on the card: every input gets a
    gradient, from the backward kernels, equal to autograd through the plain
    forward."""
    B, T, S, H, KV, D, causal, window = case
    q, k, v = (torch.from_numpy(x).to(hopper).requires_grad_()
               for x in _qkv(8, B, T, S, H, KV, D))
    g = torch.from_numpy(_qkv(9, B, T, S, H, KV, D)[0]).to(hopper)
    before = dict(LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * g).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert all(x is not None and bool(x.abs().sum() > 0) for x in got)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert LAUNCHES[name] == before[name] + 1, name
    ref_out = flash_attention_ref(q, k, v, causal=causal, window=window)[0]
    want = torch.autograd.grad((ref_out * g).sum(), (q, k, v))
    _grads_close(got, want, "float32")


@pytest.mark.cuda_sm90
def test_flash_bwd_kernels_reject_a_launch_they_cannot_make(hopper):
    # 65536 batch rows: more than the grid's z dimension takes
    q = torch.zeros(65536, 1, 1, 16, device=hopper)
    lse = torch.zeros(65536, 1, 1, device=hopper)
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention_bwd(q, q, q, q, lse, q, causal=True)
