"""Flash attention of the port: its plain version against the JAX Pallas
kernel (interpret mode), the wrapper's checks and dispatch, and the
tuned-block registry.  The CUDA kernel itself is tested in
test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import flash_attention_ref

torch.set_num_threads(1)

# (B, T, S, H, KV, D, causal, window): the reference's FLASH_CASES
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 200, 200, 8, 2, 64, True, 0),      # GQA + non-multiple length
    (1, 256, 256, 4, 1, 32, True, 64),     # MQA + sliding window
    (2, 64, 192, 2, 2, 64, False, 0),      # cross-shaped (Tq != Tk)
    (1, 130, 130, 2, 2, 128, True, 0),
]
# the reference's kernel-test tolerances: f32 2e-5, bf16 2e-2
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


def _assert_lse_close(a, b, tol):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_kernel(case, dtype):
    B, T, S, H, KV, D, causal, window = case
    q, k, v = _qkv(0, B, T, S, H, KV, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    # the Pallas kernel takes (B, H, T, D)
    jo, jl = jax_flash_fwd(*(jnp.asarray(x, jdt).transpose(0, 2, 1, 3)
                             for x in (q, k, v)),
                           causal=causal, window=window, interpret=True)
    to, tl = flash_attention_ref(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 causal=causal, window=window)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert tuple(to.shape) == (B, T, H, D) and tuple(tl.shape) == (B, H, T)
    np.testing.assert_allclose(
        to.float().numpy(),
        np.asarray(jo.astype(jnp.float32)).transpose(0, 2, 1, 3),
        atol=TOL[dtype], rtol=TOL[dtype])
    _assert_lse_close(tl.numpy(), jl, TOL[dtype])


def test_fully_masked_rows_give_zero_and_neg_inf():
    # window 8 over Tq > Tk: query rows >= Tk + 7 see no key at all
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 1, 40, 16, 2, 1, 18))
    out, lse = flash_attention_ref(q, k, v, causal=True, window=8)
    assert torch.isneginf(lse[:, :, 23:]).all()
    assert torch.isfinite(lse[:, :, :23]).all()
    assert (out[:, 23:] == 0).all()


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 33, 33, 4, 2, 80))
    before = dict(LAUNCHES)
    out, lse = flash_attention_fwd(q, k, v, causal=True, window=0)
    ro, rl = flash_attention_ref(q, k, v, causal=True, window=0)
    assert torch.equal(out, ro) and torch.equal(lse, rl)
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "heads", "head_dim", "block_q",
                                 "block_k", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 8, 8, 4, 2, 16))
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "heads":
        q = torch.zeros(1, 8, 3, 16)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(*x.shape[:3], 260) for x in (q, k, v))
    elif bad == "block_q":
        kw["block_q"] = 30
    elif bad == "block_k":
        kw["block_k"] = 48
    else:
        v = torch.zeros(1, 9, 2, 16)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(q, k, v, causal=True, **kw)


def test_tuned_block_registry_resolves_like_the_reference():
    try:
        ops.set_tuned_blocks("flash_attention", (2, 512, 512, 32, 32, 80), (64, 32))
        assert ops.tuned_blocks("flash_attention", (2, 512, 512, 32, 32, 80)) == (64, 32)
        # nearest same-rank shape by log-distance
        assert ops.tuned_blocks("flash_attention", (4, 512, 512, 32, 32, 80)) == (64, 32)
        assert ops.tuned_blocks("rmsnorm", (64, 80)) is None
        q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, 40, 40, 4, 4, 16))
        out = ops.flash_attention(q, k, v, causal=True)
        assert torch.equal(out, flash_attention_ref(q, k, v, causal=True)[0])
    finally:
        ops.clear_tuned_blocks()
    assert ops.tuned_blocks("flash_attention", (2, 512, 512, 32, 32, 80)) is None


def test_tuned_tile_for_another_head_dim_resolves_to_one_that_fits():
    """A (64, 128) winner installed at a D = 32 shape is the registry's
    nearest entry for gemma-2b's D = 256, where the forward kernel cannot
    launch it (shared memory): the entry point resolves the default tile,
    without launching anything, and its plain path takes it."""
    from repro_torch.kernels import flash_attention as fa
    shape = (2, 512, 512, 8, 1, 256)
    try:
        ops.set_tuned_blocks("flash_attention", (2, 512, 512, 8, 1, 32), (64, 128))
        assert ops.tuned_blocks("flash_attention", shape) == (64, 128)
        assert not fa.fits_shared_memory(256, 64, 128)
        before = dict(LAUNCHES)
        for elem in (4, 2):
            bq, bk = ops.flash_blocks(shape, elem)
            assert fa.fits_shared_memory(256, bq, bk, elem)
            assert (bq, bk) == fa.default_blocks(256)
        # where it fits, the winner stands; an explicit block is kept
        assert ops.flash_blocks((2, 512, 512, 8, 1, 32)) == (64, 128)
        assert ops.flash_blocks(shape, block_q=32) == (32, fa.default_blocks(256)[1])
        q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 24, 24, 2, 1, 256))
        out = ops.flash_attention(q, k, v, causal=True)
        assert torch.equal(out, flash_attention_ref(q, k, v, causal=True)[0])
        assert LAUNCHES == before
    finally:
        ops.clear_tuned_blocks()


# whisper-medium's encoder, cross and decoder attention and the VLM's self
# and cross attention: (B, T, S, H, KV, D)
CROSS_FAMILY_SHAPES = [(8, 1500, 1500, 16, 16, 64), (8, 448, 1500, 16, 16, 64),
                       (8, 448, 448, 16, 16, 64), (8, 512, 512, 64, 8, 128),
                       (8, 512, 1601, 64, 8, 128)]


@pytest.mark.parametrize("tuned_at", [(2, 512, 512, 16, 16, 64),
                                      (8, 512, 512, 32, 32, 80)])
def test_every_swept_tile_resolves_to_one_that_launches_at_the_cross_shapes(tuned_at):
    """Whatever tile kbench installs at its sweep shape (D = 64) or at
    gpt-2b's (D = 80), the registry's nearest entry for the audio and VLM
    shapes, D = 64 and 128, non-causal and cross-shaped, resolves to a tile
    the forward kernel launches: the winner where it fits, else the
    default."""
    from repro_torch.kbench.harness import _flash_grid
    from repro_torch.kernels import flash_attention as fa
    try:
        for tile in _flash_grid(tuned_at):
            ops.clear_tuned_blocks()
            ops.set_tuned_blocks("flash_attention", tuned_at, tile)
            for shape in CROSS_FAMILY_SHAPES:
                D = shape[-1]
                for elem in (4, 2):
                    bq, bk = ops.flash_blocks(shape, elem)
                    assert fa.tile_fits(D, bq, bk, elem), (tile, shape, elem)
                    want = tile if fa.tile_fits(D, *tile, elem) else fa.default_blocks(D)
                    assert (bq, bk) == want
    finally:
        ops.clear_tuned_blocks()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_explicit_tile_that_cannot_launch_is_refused_before_launching(dtype):
    """(32, 128) at D = 256 needs more shared memory than a block has: the
    wrapper says how much, on either device, and launches nothing.  64 rows
    break the wide form's block rule (2 strips) before that."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(6, 1, 16, 16, 2, 1, 256))
    need = fa.fwd_shared_bytes(256, 32, 128, q.element_size())
    assert need > fa.MAX_SHARED_BYTES
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match=f"need {need} bytes.*{fa.MAX_SHARED_BYTES}"):
        flash_attention_fwd(q, k, v, causal=True, block_q=32, block_k=128)
    with pytest.raises(ValueError, match="shared memory"):
        ops.flash_attention(q, k, v, causal=True, block_q=32, block_k=128)
    with pytest.raises(ValueError, match="block_q=64: a multiple of 16 up to 32"):
        ops.flash_attention(q, k, v, causal=True, block_q=64, block_k=32)
    assert LAUNCHES == before
