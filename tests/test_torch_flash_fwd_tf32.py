"""The precision scheme of the flash forward kernel (K1 in
``csrc/flash_attention_fwd.cu``), checked on the CPU without a card.

The kernel runs both products of attention on the tensor cores in TF32 (10
mantissa bits).  In f32 each product is three TF32 products (3xTF32, the
splitting of ``tests/test_torch_flash_bwd_tf32.py``).  Here a numpy emulation
of the kernel's arithmetic computes out and lse: S = Q.K^T through TF32
products, then the online softmax in steps of 32 keys, each step's P.V
summed from zero through TF32 products and added to the running f32 sum
after its rescale.  It is held against the reference's Pallas forward in
interpret mode and against the port's plain version at the reference's f32
tolerance (2e-5): 3xTF32 stays under half of it, one TF32 product per f32
product misses it.  bf16 inputs are exact in TF32, so S needs one product and
P.V two.  The tensor cores also truncate while they accumulate, which is not
modelled here; the kernel's own error on the card is in ``chip_smoke.py``'s
``kernel`` lines.  The sizing of the kernel's tiles is checked against the
card's shared memory.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro_torch.kernels.flash_attention import (
    KEY_STEP, MAX_BLOCK_Q, MAX_HEAD_DIM, MAX_SHARED_BYTES, ROWS_PER_WARP,
    SM_SHARED_BYTES, default_blocks, fwd_shared_bytes, fwd_wide, tile_fits,
)
from repro_torch.kernels.ref import flash_attention_ref
from test_torch_flash_bwd_tf32 import mm, tf32

TOL = 2e-5            # the reference's f32 kernel tolerance (atol = rtol)
MARGIN = 0.5          # the emulated 3xTF32 error stays under half of it
# (B, T, S, H, KV, D, causal, window): gpt-2b's head dim, GQA with a ragged
# length, and a window
CASES = [(1, 256, 256, 2, 2, 80, True, 0),
         (1, 100, 100, 4, 2, 80, True, 0),
         (1, 160, 160, 2, 1, 80, True, 48)]


def _qkv(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32))


def emulated_fwd(q, k, v, *, causal, window, products=(3, 3)):
    """out (B, T, H, D) and lse (B, H, T) with the kernel's arithmetic: S
    with products[0] TF32 products, each 32-key step's P.V with products[1]
    summed from zero and added to O after O's rescale, exp in f32, the row
    sums in f32."""
    q, k, v = (np.asarray(x, np.float32) for x in (q, k, v))
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    scale = np.float32(D ** -0.5)
    qp, kp = np.arange(T)[:, None], np.arange(S)[None, :]
    mask = np.ones((T, S), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    out = np.zeros_like(q)
    lse = np.zeros((B, H, T), np.float32)
    for b in range(B):
        for h in range(H):
            qh, kh, vh = q[b, :, h], k[b, :, h // rep], v[b, :, h // rep]
            s = np.where(mask, mm(qh, kh.T, products[0]) * scale, -np.inf)
            m = np.full((T, 1), -np.inf, np.float32)
            l = np.zeros((T, 1), np.float32)
            o = np.zeros((T, D), np.float32)
            for k0 in range(0, S, KEY_STEP):
                st = s[:, k0:k0 + KEY_STEP].astype(np.float32)
                m_new = np.maximum(m, st.max(1, keepdims=True))
                m_safe = np.where(np.isneginf(m_new), 0, m_new).astype(np.float32)
                alpha = np.where(np.isneginf(m), 0, np.exp(m - m_safe)).astype(np.float32)
                p = np.exp(st - m_safe).astype(np.float32)
                l = (alpha * l + p.sum(1, keepdims=True, dtype=np.float32)).astype(np.float32)
                part = mm(p, vh[k0:k0 + KEY_STEP], products[1])
                o = (o * alpha + part).astype(np.float32)
                m = m_new
            empty = l[:, 0] == 0
            out[b, :, h] = np.where(empty[:, None], 0, o / np.where(empty, 1, l[:, 0])[:, None])
            lse[b, h] = np.where(empty, -np.inf, m[:, 0] + np.log(np.where(empty, 1, l[:, 0])))
    return out, lse


def _references(case):
    """(Pallas forward in interpret mode, the port's plain version), each
    (out (B, T, H, D), lse (B, H, T)) as numpy, on the same inputs."""
    B, T, S, H, KV, D, causal, window = case
    q, k, v = _qkv(0, B, T, S, H, KV, D)
    jo, jl = jax_flash_fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                           causal=causal, window=window, interpret=True)
    to, tl = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, window=window)
    return (q, k, v), [(np.asarray(jo).transpose(0, 2, 1, 3), np.asarray(jl)),
                       (to.numpy(), tl.numpy())]


def _share(got, want):
    """The largest |got - want| as a share of TOL + TOL |want| (finite lse)."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    return float(np.max(np.abs(got[fin] - want[fin]) / (TOL + TOL * np.abs(want[fin]))))


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_forward_keeps_half_the_f32_tolerance(case):
    (q, k, v), refs = _references(case)
    out, lse = emulated_fwd(q, k, v, causal=case[6], window=case[7])
    for ro, rl in refs:
        assert _share(out, ro) <= MARGIN
        assert _share(lse, rl) <= MARGIN


def test_one_tf32_product_misses_the_f32_forward_tolerance():
    """Why three products: plain TF32 (one product each) fails the forward's
    f32 tolerance at gpt-2b's head dim."""
    (q, k, v), refs = _references(CASES[0])
    out, lse = emulated_fwd(q, k, v, causal=True, window=0, products=(1, 1))
    for ro, rl in refs:
        assert max(_share(out, ro), _share(lse, rl)) > 1


def test_bf16_inputs_give_the_same_bits_with_the_reduced_products():
    """The bf16 path's arithmetic (one product for S, two for P.V: only P is
    split) on bf16-valued inputs equals 3xTF32 on them, bit for bit."""
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in _qkv(1, 1, 96, 96, 2, 1, 80))
    for x in (q, k, v):
        np.testing.assert_array_equal(tf32(x), x)     # exact in TF32
    reduced = emulated_fwd(q, k, v, causal=True, window=0, products=(1, 2))
    full = emulated_fwd(q, k, v, causal=True, window=0)
    for a, b in zip(reduced, full):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("elem", [4, 2])
def test_default_tiles_fit_shared_memory_for_every_head_dim(elem):
    for d in range(1, MAX_HEAD_DIM + 1):
        bq, bk = default_blocks(d)
        assert bq % ROWS_PER_WARP == 0 and bq <= MAX_BLOCK_Q and bk % KEY_STEP == 0
        assert fwd_shared_bytes(d, bq, bk, elem) <= MAX_SHARED_BYTES, d
        assert tile_fits(d, bq, bk, elem)


def test_default_tiles_leave_room_for_two_blocks_per_sm_at_d80():
    bq, bk = default_blocks(80)
    assert (bq, bk) == (64, 64) and not fwd_wide(80) and fwd_wide(81)
    assert 2 * (fwd_shared_bytes(80, bq, bk) + 1024) <= SM_SHARED_BYTES
