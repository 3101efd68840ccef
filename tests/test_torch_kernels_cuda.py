"""The port's CUDA kernels against their plain PyTorch versions, on a Hopper
card only (marker ``cuda_sm90``; every test skips without one).  This file
imports neither jax nor the reference package, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kbench import harness
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.flash_attention import (
    MAX_HEAD_DIM, bwd_blocks, bwd_kernel_shared_bytes, bwd_shared_bytes,
    flash_attention_bwd, flash_attention_fwd, fwd_kernel_shared_bytes,
    fwd_shared_bytes,
)
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref, flash_attention_ref, rmsnorm_ref, ssd_intra_oracle,
)
from repro_torch.kernels.ssd_scan import (
    MAX_CHUNK, MAX_STATE, ssd_intra, ssd_kernel_shared_bytes, ssd_shared_bytes,
)

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
    before = LAUNCHES["flash_attention_fwd"]
    with pytest.raises(ValueError, match="shared memory"):
        # 1024 keys of 256 f32 values per tile: more shared memory than a
        # block has, refused before the launch
        flash_attention_fwd(q, q, q, causal=True, block_k=1024)
    assert LAUNCHES["flash_attention_fwd"] == before
    # 65536 query tiles: more than the grid's z dimension takes
    q = torch.zeros(1, 65536 * 16 + 1, 1, 16, device=hopper)
    with pytest.raises(RuntimeError, match="CUDA error"):
        flash_attention_fwd(q, q, q, causal=True, block_q=16)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("D", [80, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_is_bit_equal_from_launch_to_launch(hopper, dtype, D):
    """Every product and sum in a fixed order (D = 256: the wide form, whose
    row max and sums pass through shared memory)."""
    B, T, S, H, KV = 2, 256, 256, 8, 2
    q, k, v = (torch.from_numpy(x).to(hopper, getattr(torch, dtype))
               for x in _qkv(12, B, T, S, H, KV, D))
    first = flash_attention_fwd(q, k, v, causal=True)
    second = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_reads_strided_model_layout_on_wide_heads(hopper, dtype):
    """The wide form (D = 112, GQA) on views of one fused projection, and
    bf16 rows on odd element strides (plain loads)."""
    B, T, H, KV, D = 2, 150, 4, 2, 112
    qkv = torch.randn(B, T, H + 2 * KV, D + (dtype == "bfloat16"), device=hopper)
    qkv = qkv.to(getattr(torch, dtype))[..., :D]
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous()
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    ro, rl = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(lse, rl, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda_sm90
def test_flash_fwd_tile_sizing_equals_the_kernels_own(hopper):
    """fwd_shared_bytes, which decides which tiles launch, against the size
    the kernel launches with, for every head dim, dtype and kbench tile."""
    for d in range(1, MAX_HEAD_DIM + 1):
        for elem in (4, 2):
            for bq in (16, 32, 64):
                for bk in (32, 64, 128):
                    assert (fwd_shared_bytes(d, bq, bk, elem)
                            == fwd_kernel_shared_bytes(d, bq, bk, elem)), (d, elem, bq, bk)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_takes_every_tile_it_fits(hopper, dtype):
    """Each tile of kbench's grid that fits, on a ragged causal case with
    GQA and on the wide form."""
    for B, T, S, H, KV, D in ((1, 200, 200, 4, 2, 64), (1, 130, 130, 2, 1, 256)):
        q, k, v = (torch.from_numpy(x).to(hopper, getattr(torch, dtype))
                   for x in _qkv(13, B, T, S, H, KV, D))
        ro, rl = flash_attention_ref(q, k, v, causal=True)
        for bq, bk in harness.OPS["flash_attention"].block_grid((B, T, S, H, KV, D)):
            out, lse = flash_attention_fwd(q, k, v, causal=True, block_q=bq,
                                           block_k=bk)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ro.float(), atol=TOL[dtype],
                                       rtol=TOL[dtype], msg=lambda m: f"{bq, bk}: {m}")
            torch.testing.assert_close(lse, rl, atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda_sm90
def test_tuned_tile_for_another_head_dim_falls_back_to_the_default(hopper):
    """A (64, 128) winner installed at a D = 32 shape is the nearest entry
    for gemma-2b's D = 256, where it needs more shared memory than a block
    has: ops.flash_attention launches the default tile instead."""
    B, T, S, H, KV, D = 2, 512, 512, 8, 1, 256
    q, k, v = (torch.from_numpy(x).to(hopper) for x in _qkv(14, B, T, S, H, KV, D))
    try:
        ops.set_tuned_blocks("flash_attention", (2, 512, 512, 8, 1, 32), (64, 128))
        assert ops.tuned_blocks("flash_attention", (B, T, S, H, KV, D)) == (64, 128)
        before = LAUNCHES["flash_attention_fwd"]
        out = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention_fwd"] == before + 1
    finally:
        ops.clear_tuned_blocks()
    ro, _ = flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, ro, atol=TOL["float32"], rtol=TOL["float32"])


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


# Heads the backward kernels stage by narrower copies: D = 33 (rows not 16-byte
# aligned: 4-byte copies; with one bf16 head, odd element strides: plain
# loads) and D = 100 (16-byte rows, padded to 104 columns).  Heads past 80
# columns take the wide kernels (the warps of a strip share D): D = 100, the
# first wide head (D = 81, 4-byte copies), a 6-chunk share (D = 136), a
# window on D = 200, GQA on D = 96
BWD_HEAD_CASES = [
    (2, 77, 77, 4, 2, 33, True, 0),
    (1, 70, 90, 1, 1, 33, True, 0),
    (2, 150, 150, 4, 4, 100, True, 0),
    (1, 96, 160, 2, 1, 100, False, 0),
    (1, 70, 70, 2, 1, 81, True, 0),
    (2, 100, 100, 4, 2, 136, False, 0),
    (1, 96, 96, 3, 3, 200, True, 32),
    (2, 130, 130, 8, 2, 96, True, 0),
]


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", BWD_HEAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_match_plain_version_on_other_heads(hopper, case, dtype):
    test_flash_bwd_kernels_match_plain_version(hopper, case, dtype)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("D", [80, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernels_are_bit_equal_from_launch_to_launch(hopper, dtype, D):
    """No atomics: the GQA group sum and every product run in a fixed order
    (D = 256: the wide kernels)."""
    B, T, S, H, KV = 2, 256, 256, 8, 2
    q, k, v = (torch.from_numpy(x).to(hopper, getattr(torch, dtype))
               for x in _qkv(10, B, T, S, H, KV, D))
    do = torch.from_numpy(_qkv(11, B, T, S, H, KV, D)[0]).to(hopper, q.dtype)
    out, lse = flash_attention_fwd(q, k, v, causal=True)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    second = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


# The kernels' own margin under the f32 gradient tolerance, at gpt-2b's
# training shape and at four times its length.  The tensor cores truncate the
# addends they align while they accumulate, which the numpy emulation in
# tests/test_torch_flash_bwd_tf32.py does not model, so the margin is pinned
# here: every element's error stays under half of atol + rtol * |plain|.
@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", [(8, 1024, 1024, 32, 32, 80, True, 0),
                                  (1, 4096, 4096, 8, 8, 80, True, 0)])
def test_flash_bwd_kernels_keep_half_the_f32_gradient_tolerance(hopper, case):
    B, T, S, H, KV, D, causal, window = case
    q, k, v = (torch.from_numpy(x).to(hopper) for x in _qkv(6, B, T, S, H, KV, D))
    do = torch.from_numpy(_qkv(7, B, T, S, H, KV, D)[0]).to(hopper)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    atol, rtol = GRAD_TOL["float32"]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        share = ((a - b).abs() / (atol + rtol * b.abs())).max().item()
        assert share <= 0.5, (name, share)


@pytest.mark.cuda_sm90
def test_flash_bwd_block_sizing_equals_the_kernels_own(hopper):
    """bwd_shared_bytes, which picks the blocks' rows, against the size the
    kernels launch with, for every head dim, dtype and kernel."""
    for d in range(1, MAX_HEAD_DIM + 1):
        rows = bwd_blocks(d)[0]
        for elem in (4, 2):
            for dkv in (False, True):
                assert (bwd_shared_bytes(d, rows, elem, dkv)
                        == bwd_kernel_shared_bytes(d, rows, elem, dkv)), (d, elem, dkv)


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


# ---------------------------------------------------------------------------
# SSD intra-chunk (K5)
# ---------------------------------------------------------------------------

# the reference's ssd_intra tolerance (tests/test_kernels.py): f32, sums in
# other orders
SSD_TOL = dict(atol=1e-4, rtol=1e-3)

# (B, nc, Q, H, P, N, decay): decay "ref" draws the reference's property-test
# log-decays a = -0.1 |N(0, 1)|; "A=-1" is mamba2 at init, a = -dt, whose
# in-chunk span reaches ~200 at Q = 256
SSD_CASES = [
    (1, 1, 16, 1, 8, 8, "ref"),            # the reference's property space
    (2, 3, 32, 4, 16, 16, "ref"),
    (2, 2, 16, 3, 8, 16, "ref"),
    (1, 3, 32, 2, 16, 8, "ref"),
    (2, 1, 100, 8, 64, 128, "A=-1"),       # a 100-token prompt: Q = 100
    (8, 2, 256, 80, 64, 128, "A=-1"),      # mamba2-2.7b prefill, 8 x 512
    (8, 4, 256, 80, 64, 128, "A=-1"),      # mamba2-2.7b training, 8 x 1024
    (2, 2, 256, 112, 64, 64, "A=-1"),      # zamba2's N = 64
    (1, 2, 77, 3, 100, 33, "ref"),         # ragged P > 64 and N
    (1, 3, 1, 2, 8, 8, "ref"),             # a one-token chunk
    (2, 1, 65, 3, 64, 128, "A=-1"),        # one row past the first tile
]


def _ssd_inputs(seed, B, nc, Q, H, P, N, decay):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nc, Q, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))).astype(np.float32)
    a = (-dt if decay == "A=-1"
         else -0.1 * np.abs(rng.standard_normal((B, nc, Q, H)))).astype(np.float32)
    cum = np.cumsum(a, axis=2, dtype=np.float32)
    Bm = rng.standard_normal((B, nc, Q, N), np.float32)
    Cm = rng.standard_normal((B, nc, Q, N), np.float32)
    return x, dt, cum, Bm, Cm


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain_version(hopper, case):
    inputs = [torch.from_numpy(a).to(hopper) for a in _ssd_inputs(10, *case)]
    before = LAUNCHES["ssd_intra"]
    y = ssd_intra(*inputs)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_intra"] == before + 1
    assert y.shape == inputs[0].shape and y.is_contiguous()
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, ssd_intra_oracle(*inputs), **SSD_TOL)


@pytest.mark.cuda_sm90
def test_ssd_kernel_reads_strided_model_layout(hopper):
    """x, B and C as the chunked views of one fused xBC tensor, as
    ``ssd_chunked`` hands them over: strided rows, no copies."""
    B, nc, Q, H, P, N = 2, 2, 64, 4, 16, 24
    x, dt, cum, Bm, Cm = (torch.from_numpy(a).to(hopper)
                          for a in _ssd_inputs(11, B, nc, Q, H, P, N, "A=-1"))
    xbc = torch.cat([x.reshape(B, nc, Q, H * P), Bm, Cm], dim=-1)
    xs = xbc[..., :H * P].reshape(B, nc, Q, H, P)
    bs, cs = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    assert not xs.is_contiguous() and not bs.is_contiguous()
    y = ssd_intra(xs, dt, cum, bs, cs)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ssd_intra_oracle(x, dt, cum, Bm, Cm), **SSD_TOL)


def _fused_xbc(x, Bm, Cm):
    """x, B and C as the chunked views of one fused xBC tensor."""
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    xbc = torch.cat([x.reshape(B, nc, Q, H * P), Bm, Cm], dim=-1)
    return (xbc[..., :H * P].reshape(B, nc, Q, H, P), xbc[..., H * P:H * P + N],
            xbc[..., H * P + N:])


@pytest.mark.cuda_sm90
def test_ssd_kernel_reads_an_unaligned_fused_layout(hopper):
    """N = 33 and P = 100 in one fused xBC tensor: rows of x, B and C start
    off 16-byte boundaries, so the kernel stages them by 4-byte copies."""
    x, dt, cum, Bm, Cm = (torch.from_numpy(a).to(hopper)
                          for a in _ssd_inputs(16, 1, 2, 77, 3, 100, 33, "ref"))
    xs, bs, cs = _fused_xbc(x, Bm, Cm)
    assert xs.stride(2) % 4 and cs.storage_offset() % 4
    y = ssd_intra(xs, dt, cum, bs, cs)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, ssd_intra_oracle(x, dt, cum, Bm, Cm), **SSD_TOL)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("strided", [False, True])
def test_ssd_kernel_at_the_widest_head(hopper, strided):
    """P = 128 (two passes of 64 columns over the key tiles) at the longest
    chunk, in a contiguous and in the fused layout."""
    x, dt, cum, Bm, Cm = (torch.from_numpy(a).to(hopper)
                          for a in _ssd_inputs(17, 2, 2, 256, 6, 128, 128, "A=-1"))
    args = (*_fused_xbc(x, Bm, Cm),) if strided else (x, Bm, Cm)
    y = ssd_intra(args[0], dt, cum, args[1], args[2])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, ssd_intra_oracle(x, dt, cum, Bm, Cm), **SSD_TOL)


@pytest.mark.cuda_sm90
def test_ssd_kernel_is_bit_equal_from_launch_to_launch(hopper):
    """Every product and sum in a fixed order: no atomics."""
    x, dt, cum, Bm, Cm = (torch.from_numpy(a).to(hopper)
                          for a in _ssd_inputs(18, 2, 2, 256, 16, 64, 128, "A=-1"))
    xs, bs, cs = _fused_xbc(x, Bm, Cm)
    first = ssd_intra(xs, dt, cum, bs, cs)
    second = ssd_intra(xs, dt, cum, bs, cs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda_sm90
def test_ssd_block_sizing_equals_the_kernels_own(hopper):
    """ssd_shared_bytes against the size the kernel launches with, over the
    chunk and state sizes it takes."""
    for q in range(1, MAX_CHUNK + 1):
        for n in range(1, MAX_STATE + 1):
            assert ssd_shared_bytes(q, n) == ssd_kernel_shared_bytes(q, n), (q, n)


@pytest.mark.cuda_sm90
def test_ssd_kernel_is_finite_where_the_decay_span_overflows_exp(hopper):
    """dt ~ 2 over a chunk of 256 with A = -1: cum spans ~500 in the chunk,
    so exp(cum_q - cum_j) above the diagonal would be inf."""
    x, dt, cum, Bm, Cm = (torch.from_numpy(a).to(hopper)
                          for a in _ssd_inputs(12, 1, 2, 256, 4, 64, 128, "A=-1"))
    dt = dt + 1.0
    cum = torch.cumsum(-dt, dim=2)
    assert (cum[:, :, 0] - cum[:, :, -1]).min().item() > 100
    y = ssd_intra(x, dt, cum, Bm, Cm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, ssd_intra_oracle(x, dt, cum, Bm, Cm), **SSD_TOL)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("case", [SSD_CASES[1], SSD_CASES[4]])
def test_ssd_intra_gradients_match_plain(hopper, case):
    """ops.ssd_intra on the card: K5 forward, the plain oracle's VJP
    backward (no kernel launch), equal to autograd through the plain
    version."""
    inputs = [torch.from_numpy(a).to(hopper).requires_grad_()
              for a in _ssd_inputs(13, *case)]
    g = torch.from_numpy(_ssd_inputs(14, *case)[0]).to(hopper)
    before = LAUNCHES["ssd_intra"]
    y = ops.ssd_intra(*inputs)
    got = torch.autograd.grad((y * g).sum(), inputs)
    torch.cuda.synchronize()
    assert LAUNCHES["ssd_intra"] == before + 1
    want = torch.autograd.grad((ssd_intra_oracle(*inputs) * g).sum(), inputs)
    for name, a, b in zip(("x", "dt", "cum", "B", "C"), got, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, b, atol=5e-5, rtol=1e-3,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("shape", [(1, 1, 257, 1, 8, 8), (1, 1, 16, 1, 129, 8),
                                   (1, 1, 16, 1, 8, 129)])
def test_ssd_kernel_refuses_shapes_beyond_its_limits(hopper, shape):
    x, dt, cum, Bm, Cm = (torch.from_numpy(a).to(hopper)
                          for a in _ssd_inputs(15, *shape, "ref"))
    with pytest.raises(ValueError, match="the kernel takes"):
        ssd_intra(x, dt, cum, Bm, Cm)


# ---------------------------------------------------------------------------
# RMSNorm (K4)
# ---------------------------------------------------------------------------

# the reference's tolerances: f32 atol 1e-6 (numpy's default rtol 1e-7),
# bf16 2e-2 (tests/test_kernels.py); 2e-5 across swept blocks
# (tests/test_kbench.py)
RMS_TOL = {"float32": dict(atol=1e-6, rtol=1e-7),
           "bfloat16": dict(atol=2e-2, rtol=0.0)}
# at D = 2560 the kernel and the plain version sum 2560 squares in other
# orders: the sums differ by up to ~2e-7 relative, which moves y by ~1e-7
# relative plus one rounding; rtol 1e-7 leaves no margin at |y| ~ 5
RMS_WIDE_TOL = dict(atol=1e-6, rtol=1e-6)

# (x shape, dtype): the reference's cases, ragged and vector-unfriendly
# widths, one row, and the full-width hidden states of gpt-2b / mamba2
RMS_CASES = [((4, 64), "float32"), ((3, 5, 128), "float32"),
             ((128, 256), "float32"), ((4, 64), "bfloat16"),
             ((3, 5, 128), "bfloat16"), ((128, 256), "bfloat16"),
             ((1, 100), "float32"), ((200, 100), "float32"),
             ((33, 99), "bfloat16"), ((17, 99), "float32"),
             ((4096, 2560), "float32"), ((8192, 2560), "float32")]


def _rms_inputs(seed, shape, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32))
    return x.to(device, getattr(torch, dtype)), w.to(device)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("shape,dtype", RMS_CASES)
def test_rmsnorm_kernel_matches_plain_version(hopper, shape, dtype):
    x, w = _rms_inputs(20, shape, dtype, hopper)
    before = LAUNCHES["rmsnorm"]
    y = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert LAUNCHES["rmsnorm"] == before + 1
    assert y.shape == x.shape and y.dtype == x.dtype
    tol = RMS_WIDE_TOL if shape[-1] > 256 else RMS_TOL[dtype]
    torch.testing.assert_close(y.float(), rmsnorm_ref(x, w).float(), **tol)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("block_rows", [1, 32, 64, 128, 256])
@pytest.mark.parametrize("rows", [256, 200, 1])     # incl. non-multiple rows
def test_rmsnorm_kernel_correct_for_every_block(hopper, block_rows, rows):
    x, w = _rms_inputs(21, (rows, 128), "float32", hopper)
    y = ops.rmsnorm(x, w, block_rows=block_rows)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, rmsnorm_ref(x, w), atol=2e-5, rtol=2e-5)


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_strided_rows_and_weight_dtypes(hopper, w_dtype):
    """Rows read through a stride (a slice of a wider tensor), bf16 x with
    w in f32 or bf16."""
    wide, w = _rms_inputs(22, (64, 200), "bfloat16", hopper)
    x = wide[:, 8:136]                       # stride 200, width 128
    w = w[:128].to(getattr(torch, w_dtype))
    y = rn.rmsnorm(x, w, block_rows=16)
    torch.cuda.synchronize()
    assert y.is_contiguous()
    torch.testing.assert_close(y.float(), rmsnorm_ref(x, w).float(),
                               **RMS_TOL["bfloat16"])


@pytest.mark.cuda_sm90
def test_rmsnorm_kernel_refuses_what_it_cannot_take(hopper):
    x, w = _rms_inputs(23, (8, 64), "float32", hopper)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rmsnorm(x.t().contiguous().t(), w)
    with pytest.raises(TypeError, match="float16"):
        rn.rmsnorm(x.half(), w)
    with pytest.raises(ValueError, match="one device"):
        rn.rmsnorm(x, w.cpu())
    before = LAUNCHES["rmsnorm"]
    overlapping = x.as_strided((8, 64), (32, 1))   # row stride below D
    with pytest.raises(RuntimeError, match="rmsnorm failed: CUDA error"):
        rn.rmsnorm(overlapping, w)
    assert LAUNCHES["rmsnorm"] == before


@pytest.mark.cuda_sm90
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_rows", [32, 64, 128, 256])
@pytest.mark.parametrize("shape", [(4099, 2560), (200, 128), (37, 4096 + 8),
                                   (45, 9000), (70, 99)])
def test_rmsnorm_kernel_every_swept_block_on_ragged_tiles(hopper, shape, block_rows,
                                                          dtype):
    """kbench's swept row tiles on row counts none of them divides, in both
    dtypes: rows held in registers (D = 2560, 128), rows read twice (D = 4104
    in f32, 9000) and scalar rows (D = 99)."""
    x, w = _rms_inputs(24, shape, dtype, hopper)
    y = ops.rmsnorm(x, w, block_rows=block_rows)
    torch.cuda.synchronize()
    tol = RMS_WIDE_TOL if dtype == "float32" and shape[-1] > 256 else RMS_TOL[dtype]
    if dtype == "float32" and shape[-1] <= 256:
        tol = dict(atol=2e-5, rtol=2e-5)      # tests/test_kbench.py's sweep tolerance
    torch.testing.assert_close(y.float(), rmsnorm_ref(x, w).float(), **tol)


@pytest.mark.cuda_sm90
def test_kbench_collects_rmsnorm_on_the_card(hopper):
    before = LAUNCHES["rmsnorm"]
    t = harness.collect(["rmsnorm"], trials=3, warmup=2)
    # warmup, the calls that size a trial, then 3 trials of back-to-back calls
    assert LAUNCHES["rmsnorm"] >= before + 5
    (e,) = t.entries
    assert e.device == f"cuda:{torch.cuda.get_device_name(0)}"
    assert e.median_s > 0 and e.shape == (256, 128) and e.blocks == (128,)
