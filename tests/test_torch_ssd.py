"""The port's SSD modules against the JAX package, on the CPU: the plain
version of kernel K5 (``ssd_intra_ref``) and its gradient through
``ops.ssd_intra``, the chunked and sequential SSD, the causal conv, the
Mamba-2 block with its prefill state, and one decode step.

Inputs are drawn with numpy and handed to both sides.  The reference's
``ops.ssd_intra`` runs its Pallas kernel in interpret mode.  Tolerances are
f32 with sums in other orders: the reference's own ssd_intra tolerance
(atol 1e-4, rtol 1e-3) for forward values, its gradient tolerance (atol
5e-5, rtol 1e-3) for gradients at the reference's own shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import ssm as jax_ssm
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import ssm

torch.set_num_threads(1)

FWD_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)

# (B, nc, Q, H, P, N): the reference's property space
# (tests/test_kernels.py:60-77: B 1-2, nc 1-3, Q 16/32, H 1-4, P 8/16,
# N 8/16), then Q = 100 (a 100-token prompt) and Q = 256 (the published
# chunk) at small H, P and N
INTRA_CASES = [
    (1, 1, 16, 1, 8, 8), (2, 3, 32, 4, 16, 16), (2, 2, 16, 3, 8, 16),
    (1, 3, 32, 2, 16, 8), (2, 1, 32, 4, 8, 8),
    (1, 1, 100, 2, 8, 8), (1, 2, 256, 2, 8, 16),
]


def _intra_inputs(seed, B, nc, Q, H, P, N):
    """The reference test's draws: dt = softplus(N(0,1)), log-decays
    a = -0.1 |N(0,1)| and cum their inclusive cumsum over the chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, nc, Q, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))).astype(np.float32)
    a = (-0.1 * np.abs(rng.standard_normal((B, nc, Q, H)))).astype(np.float32)
    cum = np.cumsum(a, axis=2, dtype=np.float32)
    Bm = rng.standard_normal((B, nc, Q, N), np.float32)
    Cm = rng.standard_normal((B, nc, Q, N), np.float32)
    return x, dt, cum, Bm, Cm


def _t(arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("case", INTRA_CASES)
def test_ssd_intra_ref_matches_reference_kernel(case):
    inputs = _intra_inputs(0, *case)
    ref = jax_ops.ssd_intra(*map(jnp.asarray, inputs))
    got = ssm.ssd_intra_ref(*_t(inputs))
    assert got.dtype == torch.float32 and tuple(got.shape) == case[:5]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)
    # the wrapper's CPU path is the same plain version
    np.testing.assert_array_equal(ops.ssd_intra(*_t(inputs)).numpy(), got.numpy())


@pytest.mark.parametrize("case", INTRA_CASES[:4])
def test_ssd_intra_gradient_matches_reference_custom_vjp(case):
    """``ops.ssd_intra``'s backward (the plain oracle's VJP) against
    ``jax.grad`` through the reference's ``custom_vjp`` at Q <= 32."""
    inputs = _intra_inputs(1, *case)
    g = np.random.default_rng(2).standard_normal(case[:5]).astype(np.float32)

    def loss(*xs):
        return jnp.sum(jax_ops.ssd_intra(*xs) * g)
    want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, inputs))
    ts = _t(inputs, grad=True)
    got = torch.autograd.grad((ops.ssd_intra(*ts) * torch.from_numpy(g)).sum(), ts)
    for name, a, b in zip(("x", "dt", "cum", "B", "C"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


def _ssd_inputs(seed, B, T, H, P, N):
    """mamba2 at init: dt = softplus(N(0,1)), A = -exp(A_log = 0) = -1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.ones((H,), np.float32)
    Bm = rng.standard_normal((B, T, N), np.float32)
    Cm = rng.standard_normal((B, T, N), np.float32)
    return x, dt, A, Bm, Cm


NAN_CASE = dict(B=1, T=256, H=2, P=4, N=4, chunk=256)


def _naive_grads_jax(inputs, gy, gs):
    def loss(x, dt, A, Bm, Cm):
        y, s = jax_ssm.ssd_naive(x, dt, A, Bm, Cm)
        return jnp.sum(y * gy) + jnp.sum(s * gs)
    return jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, inputs))


def test_ssd_chunked_gradients_are_finite_at_the_published_chunk():
    """At chunk 256, T = 256, dt = softplus(N(0,1)) and A = -1, the port's
    chunked SSD has finite gradients with respect to x, dt, A, B and C,
    equal to ``jax.grad`` of the reference's sequential ``ssd_naive``, whose
    per-step decay ``exp(A dt) <= 1`` cannot overflow.

    The reference's own ``ssd_chunked`` is no yardstick here: its
    intra-chunk decay ``where(j <= q, exp(cum_q - cum_j), 0)`` overflows to
    inf above the diagonal (the span of cum reaches ~200), and its backward
    multiplies the zero cotangent there by inf, so every element of its
    gradient is NaN (see the next test).  The port masks before exp.

    Tolerance: the chunked and sequential algorithms sum in other orders
    over 256 steps, and the gradient of A sums over every step and head:
    atol 1e-3 with rtol 1e-3 (elements up to ~40; measured at most 6.7e-4
    apart for A, whose gradient is ~11, and 9.1e-5 for the others)."""
    c = NAN_CASE
    inputs = _ssd_inputs(3, c["B"], c["T"], c["H"], c["P"], c["N"])
    rng = np.random.default_rng(4)
    gy = rng.standard_normal(inputs[0].shape).astype(np.float32)
    gs = rng.standard_normal((c["B"], c["H"], c["P"], c["N"])).astype(np.float32)
    ts = _t(inputs, grad=True)
    y, s = ssm.ssd_chunked(*ts, c["chunk"], use_kernels=True)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum()
                              + (s * torch.from_numpy(gs)).sum(), ts)
    want = _naive_grads_jax(inputs, gy, gs)
    for name, a, b in zip(("x", "dt", "A", "B", "C"), got, want):
        assert bool(torch.isfinite(a).all()), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3,
                                   rtol=1e-3, err_msg=name)


def test_reference_chunked_gradient_is_nan_at_the_published_chunk():
    """The fault the port does not copy: the reference's ``ssd_chunked``
    gradient at chunk 256 is NaN where the port's is finite (above).  At
    chunk 32 the span stays small and the reference is finite."""
    c = NAN_CASE
    x, dt, A, Bm, Cm = map(jnp.asarray, _ssd_inputs(3, c["B"], c["T"], c["H"],
                                                    c["P"], c["N"]))

    def grad_dt(chunk):
        return jax.grad(lambda d: jnp.sum(
            jax_ssm.ssd_chunked(x, d, A, Bm, Cm, chunk)[0]))(dt)
    assert np.isnan(np.asarray(grad_dt(256))).all()
    assert np.isfinite(np.asarray(grad_dt(32))).all()


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 6), np.float32)
    w = rng.standard_normal((4, 6), np.float32)
    b = rng.standard_normal((6,), np.float32)
    ref = jax_ssm.causal_conv1d(*map(jnp.asarray, (x, w, b)))
    got = ssm.causal_conv1d(*_t((x, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("T,chunk", [(70, 32), (64, 32), (20, 32)])
def test_ssd_chunked_matches_naive_and_reference(T, chunk):
    """T not a multiple of the chunk (padding), a multiple, and T < chunk
    (Q = T); with and without an initial state."""
    inputs = _ssd_inputs(6, 2, T, 3, 8, 5)
    s0 = np.random.default_rng(7).standard_normal((2, 3, 8, 5)).astype(np.float32)
    for init in (None, s0):
        y, s = ssm.ssd_chunked(*_t(inputs), chunk, use_kernels=True,
                               init_state=None if init is None
                               else torch.from_numpy(init))
        yn, sn = ssm.ssd_naive(*_t(inputs), init_state=None if init is None
                               else torch.from_numpy(init))
        ry, rs = jax_ssm.ssd_chunked(*map(jnp.asarray, inputs), chunk,
                                     init_state=None if init is None
                                     else jnp.asarray(init), use_pallas=True)
        for a, b in ((y, yn), (s, sn)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **FWD_TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), **FWD_TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), **FWD_TOL)


DIMS = dict(d_inner=32, d_state=8, n_heads=4, head_dim=8)


def _block_params():
    p = jax_ssm.ssm_init(jax.random.PRNGKey(8), 16, DIMS["d_inner"],
                         DIMS["d_state"], DIMS["n_heads"], 4)
    # a non-trivial A_log, dt_bias, D and norm so every leaf matters
    rng = np.random.default_rng(9)
    p = jax.tree.map(np.asarray, p)
    for k in ("A_log", "dt_bias", "D"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("T", [2, 40])
def test_ssm_block_with_state_matches_reference(T):
    """The block's output and its prefill state (final SSD state and conv
    tail; T = 2 < K - 1 pads the tail on the left)."""
    p_np = _block_params()
    h = np.random.default_rng(10).standard_normal((2, T, 16)).astype(np.float32)
    ref_out, ref_st = jax_ssm.ssm_block(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(h), chunk=16,
        use_pallas=True, return_state=True, **DIMS)
    out, st = ssm.ssm_block(params_from_jax(p_np), torch.from_numpy(h), chunk=16,
                            use_kernels=True, return_state=True, **DIMS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **FWD_TOL)
    assert sorted(st) == sorted(ref_st) == ["conv", "s"]
    for k in st:
        assert st[k].dtype == torch.float32
        np.testing.assert_allclose(st[k].numpy(), np.asarray(ref_st[k]), **FWD_TOL)


def test_ssm_decode_step_matches_reference_and_continues_the_block():
    """One decode step from a prefill state equals the reference's step, and
    equals the block's output at the next position."""
    p_np = _block_params()
    p_t = params_from_jax(p_np)
    h = np.random.default_rng(11).standard_normal((2, 21, 16)).astype(np.float32)
    _, st = ssm.ssm_block(p_t, torch.from_numpy(h[:, :20]), chunk=16,
                          return_state=True, **DIMS)
    out, new = ssm.ssm_decode_step(p_t, torch.from_numpy(h[:, 20:]), st, **DIMS)
    ref_out, ref_new = jax_ssm.ssm_decode_step(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(h[:, 20:]),
        {k: jnp.asarray(v.numpy()) for k, v in st.items()}, **DIMS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **FWD_TOL)
    for k in new:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(ref_new[k]), **FWD_TOL)
    full = ssm.ssm_block(p_t, torch.from_numpy(h), chunk=16, **DIMS)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, 20].numpy(), **FWD_TOL)
    zero = ssm.ssm_init_state(2, DIMS["d_inner"], DIMS["d_state"],
                              DIMS["n_heads"], DIMS["head_dim"], 4)
    assert tuple(zero["s"].shape) == (2, 4, 8, 8)
    assert tuple(zero["conv"].shape) == (2, 3, 32 + 16)
