"""Flash attention backward of the port: the plain dq and dk/dv contracts
(``kernels/ref.py``) against the JAX Pallas backward kernels in interpret
mode, and gradients through ``repro_torch.kernels.ops.flash_attention``
(``FlashAttention``) against ``jax.vjp`` of the reference's
``ops.flash_attention``.  The CUDA kernels themselves are tested in
test_torch_kernels_cuda.py.

Tolerance: the reference's gradient tolerance (tests/test_kernels.py),
atol 5e-5 / rtol 1e-3, f32 on both sides; only summation orders differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_bwd as jax_flash_bwd
from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_dkv, flash_attention_bwd_dq,
)
from repro_torch.kernels.ref import (
    flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
)

torch.set_num_threads(1)

ATOL, RTOL = 5e-5, 1e-3

# (B, T, S, H, KV, D, causal, window): the reference's FLASH_CASES
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 200, 200, 8, 2, 64, True, 0),      # GQA + non-multiple length
    (1, 256, 256, 4, 1, 32, True, 64),     # MQA + sliding window
    (2, 64, 192, 2, 2, 64, False, 0),      # cross-shaped (Tq != Tk)
    (1, 130, 130, 2, 2, 128, True, 0),
]
# block multiples of the Pallas kernels' 128 x 128 blocks, for the direct
# kernel comparison (the Pallas backward takes pre-padded inputs)
BLOCK_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 128, 4, 2, 32, False, 0),     # GQA, Tq != Tk
    (1, 256, 256, 4, 1, 32, True, 64),     # MQA + sliding window
]
# Tq > Tk with a window: query rows >= 55 see no key (lse = -inf)
MASKED_CASE = (1, 100, 40, 2, 1, 80, True, 16)


def _inputs(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, S, KV, D), np.float32),
            rng.standard_normal((B, T, H, D), np.float32))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL)


def _pallas_case(case):
    """Pallas forward + backward in kernel layout (B, H, T, D), interpret
    mode; returns model-layout torch inputs, out, lse and the reference's
    dq, dk, dv (dk/dv summed over each GQA group, as ops.py does)."""
    B, T, S, H, KV, D, causal, window = case
    q, k, v, do = _inputs(0, B, T, S, H, KV, D)
    qt, kt, vt, dot = (jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v, do))
    out, lse = jax_flash_fwd(qt, kt, vt, causal=causal, window=window,
                             interpret=True)
    dq, dk, dv = jax_flash_bwd(qt, kt, vt, out, lse, dot, causal=causal,
                               window=window, interpret=True)
    rep = H // KV
    dk = np.asarray(dk).reshape(B, KV, rep, S, D).sum(axis=2).transpose(0, 2, 1, 3)
    dv = np.asarray(dv).reshape(B, KV, rep, S, D).sum(axis=2).transpose(0, 2, 1, 3)
    dq = np.asarray(dq).transpose(0, 2, 1, 3)
    port = [torch.from_numpy(x) for x in (q, k, v, do)]
    port += [torch.from_numpy(np.asarray(out).transpose(0, 2, 1, 3).copy()),
             torch.from_numpy(np.array(lse))]
    return port, (dq, dk, dv)


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_dq_plain_matches_pallas_dq_kernel(case):
    (q, k, v, do, out, lse), (dq, _, _) = _pallas_case(case)
    tdq, delta = flash_attention_bwd_dq_ref(q, k, v, out, lse, do,
                                            causal=case[6], window=case[7])
    _close(tdq, dq)
    assert delta.shape == lse.shape and delta.dtype == torch.float32


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_dkv_plain_matches_pallas_dkv_kernel(case):
    (q, k, v, do, out, lse), (_, dk, dv) = _pallas_case(case)
    delta = (do * out).sum(-1).permute(0, 2, 1)
    tdk, tdv = flash_attention_bwd_dkv_ref(q, k, v, lse, do, delta,
                                           causal=case[6], window=case[7])
    _close(tdk, dk)
    _close(tdv, dv)


def _vjp_case(case, seed):
    B, T, S, H, KV, D, causal, window = case
    q, k, v, g = _inputs(seed, B, T, S, H, KV, D)
    out, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(
        q, k, v, causal=causal, window=window, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    before = dict(LAUNCHES)
    tout = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert tout.grad_fn is not None
    grads = torch.autograd.grad(tout, (tq, tk, tv), torch.from_numpy(g))
    assert LAUNCHES == before          # the CPU path launches nothing
    _close(tout, out)
    return grads, ref


@pytest.mark.parametrize("case", FLASH_CASES)
def test_autograd_through_flash_attention_matches_reference_vjp(case):
    grads, ref = _vjp_case(case, 1)
    for name, t, j in zip(("dq", "dk", "dv"), grads, ref):
        assert t.shape == j.shape, name
        _close(t, j)


def test_fully_masked_rows_get_zero_dq_and_match_reference():
    grads, ref = _vjp_case(MASKED_CASE, 2)
    for t, j in zip(grads, ref):
        assert torch.isfinite(t).all()
        _close(t, j)
    assert (grads[0][:, 55:] == 0).all()


def test_plain_backward_is_autograd_of_the_plain_forward():
    """The K2/K3 contract equals autograd through the plain forward, also
    with GQA, a window and fully masked rows."""
    from repro_torch.kernels.ref import flash_attention_ref
    for case in (FLASH_CASES[1], MASKED_CASE):
        B, T, S, H, KV, D, causal, window = case
        q, k, v, g = (torch.from_numpy(x) for x in _inputs(3, B, T, S, H, KV, D))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out, lse = flash_attention_ref(q, k, v, causal=causal, window=window)
        want = torch.autograd.grad(out, (q, k, v), g)
        got = flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                  out.detach(), lse.detach(), g,
                                  causal=causal, window=window)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_backward_wrappers_on_cpu_are_the_plain_versions():
    B, T, S, H, KV, D = 2, 33, 33, 4, 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, B, T, S, H, KV, D))
    from repro_torch.kernels.ref import flash_attention_ref
    out, lse = flash_attention_ref(q, k, v, causal=True)
    before = dict(LAUNCHES)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal=True)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, causal=True)
    assert LAUNCHES == before
    rdq, rdelta = flash_attention_bwd_dq_ref(q, k, v, out, lse, do, causal=True)
    rdk, rdv = flash_attention_bwd_dkv_ref(q, k, v, lse, do, rdelta, causal=True)
    for a, b in ((dq, rdq), (delta, rdelta), (dk, rdk), (dv, rdv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["out_shape", "lse_shape", "lse_dtype",
                                 "do_dtype", "kv_heads", "delta"])
def test_backward_wrappers_reject_what_the_kernels_do_not_take(bad):
    B, T, S, H, KV, D = 1, 8, 8, 4, 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, B, T, S, H, KV, D))
    out, lse = q.clone(), torch.zeros(B, H, T)
    delta = torch.zeros(B, H, T)
    if bad == "out_shape":
        out = torch.zeros(B, T + 1, H, D)
    elif bad == "lse_shape":
        lse = torch.zeros(B, T, H)
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_dtype":
        do = do.double()
    elif bad == "kv_heads":                     # 4 query heads over 3 kv heads
        k, v = torch.zeros(B, S, 3, D), torch.zeros(B, S, 3, D)
    if bad == "delta":
        with pytest.raises(ValueError):
            flash_attention_bwd_dkv(q, k, v, lse, do, delta[:, :1], causal=True)
        return
    with pytest.raises((ValueError, TypeError)):
        flash_attention_bwd(q, k, v, out, lse, do, causal=True)
