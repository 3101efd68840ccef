"""The precision scheme of the SSD intra-chunk kernel (K5 in
``csrc/ssd_intra.cu``), checked on the CPU without a card.

The kernel runs both of its products, C.B^T and M x, on the tensor cores in
TF32 (10 mantissa bits), each f32 product as three TF32 products (3xTF32):
an operand x splits into big = x rounded to TF32 (to nearest, ties away from
zero, as ``cvt.rna``) and small = x - big, which the mma reads truncated to
TF32 (its low 13 bits ignored), and a.b is taken as small.big + big.small +
big.big.  Here a numpy emulation of the kernel's arithmetic computes y:
C.B^T summed over 32 state columns at a time, M = CB * exp(cum_q - cum_j) *
dt_j in f32 with the exponent masked before ``exp`` (``__expf``: exp2 of the
exponent times log2 e), and M x summed per tile of 32 keys and added to the
running f32 sum in the kernel's order.  It is held against the reference's
Pallas ``ssd_intra`` in interpret mode and against the port's plain version
at the reference's tolerance (atol 1e-4, rtol 1e-3): 3xTF32 stays under half
of it.  Whether one TF32 product per f32 product would stay within the
tolerance is recorded, not asserted.  The tensor cores also truncate while
they accumulate, which is not modelled here; the kernel's own error on the
card is in ``chip_smoke.py``'s ``kernel`` lines.  The kernel's shared memory
is checked against a block's for every size it takes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_intra as jax_ssd_intra
from repro_torch.kernels.flash_attention import MAX_SHARED_BYTES, SM_SHARED_BYTES
from repro_torch.kernels.ref import ssd_intra_oracle
from repro_torch.kernels.ssd_scan import (
    KEY_TILE, MAX_CHUNK, MAX_STATE, ssd_shared_bytes,
)
from test_torch_flash_bwd_tf32 import tf32

ATOL, RTOL = 1e-4, 1e-3   # the reference's ssd_intra tolerance
MARGIN = 0.5              # the emulated 3xTF32 error stays under half of it
SLICE = 32                # state columns per partial sum of C.B^T
LOG2E = np.float32(1.4426950408889634)
# (B, nc, Q, H, P, N, decay): chip_smoke.py's SSD_CASES at the reference's
# property sizes, its ragged case, and the published chunk with mamba2's
# "A=-1" decay (in-chunk span ~200) at small H
CASES = [
    (1, 1, 16, 1, 8, 8, "ref"),
    (2, 3, 32, 4, 16, 16, "ref"),
    (2, 2, 16, 3, 8, 16, "ref"),
    (1, 3, 32, 2, 16, 8, "ref"),
    (1, 2, 77, 3, 100, 33, "ref"),
    (1, 2, 256, 2, 64, 128, "A=-1"),
]


def _inputs(seed, B, nc, Q, H, P, N, decay):
    """The card tests' draws: dt = softplus(N(0, 1)); log-decays a =
    -0.1 |N(0, 1)| ("ref", the reference's) or a = -dt ("A=-1"); cum their
    inclusive cumsum over the chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nc, Q, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))).astype(np.float32)
    a = (-dt if decay == "A=-1"
         else -0.1 * np.abs(rng.standard_normal((B, nc, Q, H)))).astype(np.float32)
    cum = np.cumsum(a, axis=2, dtype=np.float32)
    Bm = rng.standard_normal((B, nc, Q, N), np.float32)
    Cm = rng.standard_normal((B, nc, Q, N), np.float32)
    return x, dt, cum, Bm, Cm


def split(x: np.ndarray):
    """(big, small) as the kernel's operands: big rounded to TF32, small =
    x - big as the mma reads it, truncated to TF32."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    small = (x - big).view(np.uint32) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


def mm(a: np.ndarray, b: np.ndarray, products: int) -> np.ndarray:
    """a @ b in f32 through TF32 products: 3 (small.big + big.small, then
    big.big) or 1 (big.big)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    if products == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def fast_exp(d: np.ndarray) -> np.ndarray:
    """``__expf``: 2 ** (d * log2 e), the product rounded to f32."""
    return np.exp2((np.asarray(d, np.float32) * LOG2E).astype(np.float64)).astype(np.float32)


def emulated_ssd_intra(x, dt, cum, Bm, Cm, products=3):
    """y (B, nc, Q, H, P) with the kernel's arithmetic."""
    B, nc, Q, H, P = x.shape
    N = Bm.shape[-1]
    q, j = np.arange(Q)[:, None], np.arange(Q)[None, :]
    y = np.zeros_like(x)
    for b in range(B):
        for c in range(nc):
            cb = np.zeros((Q, Q), np.float32)
            for n0 in range(0, N, SLICE):
                cb = (cb + mm(Cm[b, c, :, n0:n0 + SLICE],
                              Bm[b, c, :, n0:n0 + SLICE].T, products)).astype(np.float32)
            for h in range(H):
                cu = cum[b, c, :, h]
                d = np.where(j <= q, cu[:, None] - cu[None, :], -np.inf).astype(np.float32)
                m = (cb * fast_exp(d)).astype(np.float32) * dt[b, c, :, h][None, :]
                acc = np.zeros((Q, P), np.float32)
                for j0 in range(0, Q, KEY_TILE):
                    acc = (acc + mm(m[:, j0:j0 + KEY_TILE],
                                    x[b, c, j0:j0 + KEY_TILE, h], products)).astype(np.float32)
                y[b, c, :, h] = acc
    return y


def _references(inputs):
    """(the Pallas kernel in interpret mode, the port's plain version) on the
    same inputs, as numpy."""
    jy = jax_ssd_intra(*map(jnp.asarray, inputs), interpret=True)
    ty = ssd_intra_oracle(*(torch.from_numpy(a) for a in inputs))
    return np.asarray(jy), ty.numpy()


def _share(got, want):
    """The largest |got - want| as a share of atol + rtol |want|."""
    assert np.isfinite(got).all()
    return float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_ssd_intra_keeps_half_the_tolerance(case):
    inputs = _inputs(0, *case)
    got = emulated_ssd_intra(*inputs)
    for ref in _references(inputs):
        assert _share(got, ref) <= MARGIN


def test_one_tf32_product_is_recorded_against_the_tolerance(record_property):
    """Plain TF32 (one product per f32 product) at the published chunk: its
    share of the tolerance is recorded; whether it passes is not asserted."""
    inputs = _inputs(0, *CASES[-1])
    got = emulated_ssd_intra(*inputs, products=1)
    shares = [_share(got, ref) for ref in _references(inputs)]
    record_property("one_product_share_of_tolerance", max(shares))
    assert all(np.isfinite(s) and s > 0 for s in shares)


def test_the_exponent_is_masked_before_exp():
    """Above the diagonal cum_q - cum_j is a positive sum of dt's, ~200 at
    the published chunk: exp of it is inf, and inf * 0 would be NaN."""
    inputs = _inputs(1, 1, 1, 256, 1, 8, 16, "A=-1")
    cum = inputs[2][0, 0, :, 0]
    assert cum[0] - cum[-1] > 100 and np.isinf(np.exp(np.float32(cum[0] - cum[-1])))
    assert np.isfinite(emulated_ssd_intra(*inputs)).all()


def test_shared_memory_fits_a_block_for_every_size():
    """Every chunk and state size the kernel takes fits a block's shared
    memory (the head dim does not change it), and with the 1 KB an SM
    reserves per block, one block per SM."""
    sizes = {(q, n): ssd_shared_bytes(q, n)
             for q in range(1, MAX_CHUNK + 1) for n in range(1, MAX_STATE + 1)}
    assert max(sizes.values()) <= MAX_SHARED_BYTES
    assert max(sizes.values()) + 1024 <= SM_SHARED_BYTES
    # mamba2-2.7b: the published chunk of 256 at N = 128 is the largest
    assert sizes[(MAX_CHUNK, MAX_STATE)] == max(sizes.values())
