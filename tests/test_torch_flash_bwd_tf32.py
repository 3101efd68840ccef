"""The precision scheme of the flash backward kernels (K2 dq, K3 dk/dv in
``csrc/flash_attention_bwd.cu``), checked on the CPU without a card.

The kernels run every product on the tensor cores in TF32 (10 mantissa
bits).  In f32 each product is three TF32 products (3xTF32): every operand x
splits into big = tf32(x) and small = tf32(x - big), and a.b is taken as
small.big + big.small + big.big.  Here a numpy emulation of that arithmetic
(``cvt.rna``: round to nearest, ties away from zero, on the f32 bit pattern)
computes dq, dk, dv and holds them against the reference's Pallas backward in
interpret mode, at the reference's gradient tolerance (atol 5e-5, rtol 1e-3)
and at a tenth of it: that pins the margin of the operand splitting, with
every sum taken in f32.  The tensor cores also truncate while they
accumulate, which is not modelled here; the kernels' own margin on the card
(under half the tolerance) is pinned in ``tests/test_torch_kernels_cuda.py``.
One TF32 product per f32 product misses the tolerance.  bf16 values are exact in TF32, so with bf16
operands S and dP need one product and dQ, dK, dV two.  The sizing of the
kernels' blocks (``bwd_blocks``) is checked against the card's shared memory.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    BWD_MAX_BLOCK_ROWS, BWD_ROWS_PER_WARP, BWD_TILE, MAX_HEAD_DIM,
    MAX_SHARED_BYTES, SM_SHARED_BYTES, bwd_blocks, bwd_shared_bytes,
)
from test_torch_flash_bwd import BLOCK_CASES, _pallas_case

ATOL, RTOL = 5e-5, 1e-3
MARGIN = 0.1          # the emulated splitting's error stays under a tenth of it
# gpt-2b's head dim, causal, at a length the Pallas kernels' blocks divide
D80_CASE = (1, 256, 256, 2, 2, 80, True, 0)


def tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero, keeping 10 mantissa bits (the low 13 bits zero)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = tf32(x)
    return big, tf32(np.asarray(x, np.float32) - big)


def mm(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a @ b in f32 through TF32 products: 3 (3xTF32), 2 (only a split: b
    exact in TF32) or 1 (plain TF32)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if products == 1:
        return ab @ bb
    if products == 2:
        return as_ @ bb + ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def emulated_bwd(q, k, v, out, lse, do, *, causal, window, products=(3, 3)):
    """dq, dk, dv (model layout, dk/dv summed over each GQA group) with the
    kernels' arithmetic: S and dP with products[0] TF32 products each, dQ,
    dK, dV with products[1]; P, dS, delta, exp in f32."""
    q, k, v, out, do = (np.asarray(x, np.float32) for x in (q, k, v, out, do))
    lse = np.asarray(lse, np.float32)
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
    dq = np.zeros_like(q)
    dk = np.zeros_like(k)
    dv = np.zeros_like(v)
    for b in range(B):
        for h in range(H):
            hk = h // rep
            qh, gh, kh, vh = q[b, :, h], do[b, :, h], k[b, :, hk], v[b, :, hk]
            s = mm(qh, kh.T, products[0])
            dp = mm(gh, vh.T, products[0])
            live = np.isfinite(lse[b, h])[:, None] & mask
            arg = np.where(live, s * scale - lse[b, h][:, None], 0).astype(np.float32)
            p = np.where(live, np.exp(arg), 0).astype(np.float32)
            delta = (gh * out[b, :, h]).sum(-1, dtype=np.float32)[:, None]
            ds = (p * (dp - delta) * scale).astype(np.float32)
            dq[b, :, h] = mm(ds, kh, products[1])
            dk[b, :, hk] += mm(ds.T, qh, products[1])
            dv[b, :, hk] += mm(p.T, gh, products[1])
    return dq, dk, dv


def _emulate_case(case, products=(3, 3)):
    (q, k, v, do, out, lse), ref = _pallas_case(case)
    got = emulated_bwd(*(x.numpy() for x in (q, k, v, out, lse, do)),
                       causal=case[6], window=case[7], products=products)
    return got, ref


def _excess(got, want, margin=1.0):
    """Largest amount by which |got - want| exceeds margin * (atol + rtol |want|)."""
    return float(np.max(np.abs(got - want) - margin * (ATOL + RTOL * np.abs(want))))


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one_ulp = 2.0 ** -10                       # TF32's ulp at 1
    x = np.array([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                  1 + 3 * one_ulp / 4, 3.0], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + one_ulp, -(1 + one_ulp), 1, 1 + one_ulp, 3],
                          np.float32))
    big, small = split(np.float32(np.pi))
    assert tf32(big) == big and tf32(small) == small
    assert abs(float(big) + float(small) - float(np.float32(np.pi))) <= 2.0 ** -22 * np.pi


@pytest.mark.parametrize("case", BLOCK_CASES + [D80_CASE])
def test_3xtf32_backward_matches_pallas_backward_with_margin(case):
    got, ref = _emulate_case(case)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL, err_msg=name)
        assert _excess(g, r, MARGIN) <= 0, (name, _excess(g, r, MARGIN))


def test_one_tf32_product_misses_the_f32_gradient_tolerance():
    """Why three products: plain TF32 (one product each) fails the gradient
    tolerance at gpt-2b's head dim."""
    got, ref = _emulate_case(D80_CASE, products=(1, 1))
    assert max(_excess(g, r) for g, r in zip(got, ref)) > 0


def test_bf16_operands_need_one_product_for_s_and_dp_and_two_for_the_rest():
    rng = np.random.default_rng(3)
    x, y = (torch.from_numpy(rng.standard_normal((64, 80), np.float32))
            .bfloat16().float().numpy() for _ in range(2))
    for m in (x, y):
        big, small = split(m)
        np.testing.assert_array_equal(big, m)   # exact in TF32
        assert not small.any()
    np.testing.assert_array_equal(mm(x, y.T, 1), mm(x, y.T, 3))   # S, dP
    p = rng.standard_normal((80, 64)).astype(np.float32)          # P or dS
    np.testing.assert_array_equal(mm(p, x, 2), mm(p, x, 3))       # dQ, dK, dV
    assert not np.array_equal(mm(p, x, 1), mm(p, x, 3))           # P is split


def test_bf16_inputs_give_the_same_bits_with_the_reduced_products():
    """The bf16 path's arithmetic (one product for S and dP, two for dQ, dK,
    dV) on bf16-valued inputs equals 3xTF32 on them, bit for bit."""
    (q, k, v, do, out, lse), _ = _pallas_case(D80_CASE)
    q, k, v, do = (x.bfloat16().float().numpy() for x in (q, k, v, do))
    kw = dict(causal=True, window=0)
    reduced = emulated_bwd(q, k, v, out.numpy(), lse.numpy(), do,
                           products=(1, 2), **kw)
    full = emulated_bwd(q, k, v, out.numpy(), lse.numpy(), do, **kw)
    for a, b in zip(reduced, full):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("elem", [4, 2])
def test_bwd_blocks_fit_shared_memory_for_every_head_dim(elem):
    for d in range(1, MAX_HEAD_DIM + 1):
        rows, tile = bwd_blocks(d)
        assert tile == BWD_TILE
        assert rows % BWD_ROWS_PER_WARP == 0 and rows <= BWD_MAX_BLOCK_ROWS
        for dkv in (False, True):
            assert bwd_shared_bytes(d, rows, elem, dkv) <= MAX_SHARED_BYTES, d


def test_bwd_blocks_leave_room_for_two_blocks_per_sm_at_d80():
    rows, _ = bwd_blocks(80)
    assert rows == BWD_MAX_BLOCK_ROWS
    per_block = bwd_shared_bytes(80, rows) + 1024   # 1 KB reserved per block
    assert 2 * per_block <= SM_SHARED_BYTES
