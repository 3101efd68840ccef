"""The port's RMSNorm entry point (``ops.rmsnorm``, kernel K4's wrapper) on
the CPU against the JAX package's ``ops.rmsnorm`` (its Pallas kernel in
interpret mode) and its plain ``rmsnorm_ref``.

Inputs are drawn with numpy and handed to both sides.  Tolerances are the
reference's own: f32 atol 1e-6 and bf16 2e-2 (``tests/test_kernels.py``
``test_rmsnorm``), 2e-5 across swept blocks (``tests/test_kbench.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import rmsnorm_ref

torch.set_num_threads(1)

TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _inputs(seed, shape, w_scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + w_scale * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x, w


def _both(x, w, dtype):
    """(port x, port w, reference x, reference w): x in ``dtype``, w f32."""
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    return xt, torch.from_numpy(w), xj, jnp.asarray(w)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 128), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(shape, dtype):
    """The reference's cases: ``ops.rmsnorm`` with its default blocks."""
    xt, wt, xj, wj = _both(*_inputs(7, shape), dtype)
    before = dict(LAUNCHES)
    out = ops.rmsnorm(xt, wt)
    assert LAUNCHES == before                     # the CPU launches nothing
    assert out.shape == xt.shape and out.dtype == xt.dtype
    for ref in (jax_ops.rmsnorm(xj, wj), jax_rmsnorm_ref(xj, wj)):
        np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype])


@pytest.mark.parametrize("block_rows", [32, 64, 256])
@pytest.mark.parametrize("rows", [256, 200])        # incl. non-multiple rows
def test_rmsnorm_correct_for_all_swept_blocks(block_rows, rows):
    x, w = _inputs(1, (rows, 128), w_scale=1.0)
    out = ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w),
                      block_rows=block_rows)
    ref = jax_ops.rmsnorm(jnp.asarray(x), jnp.asarray(w), block_rows=block_rows)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,dtype", [((1, 100), "float32"),
                                         ((7, 99), "bfloat16"),
                                         ((5, 33), "float32")])
def test_rmsnorm_ragged_widths_and_single_row(shape, dtype):
    """Widths that are not a multiple of the kernel's vector width, and one
    row, against the reference's plain version."""
    xt, wt, xj, wj = _both(*_inputs(3, shape), dtype)
    out = ops.rmsnorm(xt, wt, eps=1e-5)
    np.testing.assert_allclose(_np(out), _np(jax_rmsnorm_ref(xj, wj, eps=1e-5)),
                               atol=TOL[dtype])


def test_rmsnorm_weight_in_x_dtype():
    """bf16 x with bf16 w: statistics and product in f32, output bf16."""
    x, w = _inputs(4, (16, 64))
    xt, wt = (torch.from_numpy(a).bfloat16() for a in (x, w))
    xj, wj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w))
    out = ops.rmsnorm(xt, wt)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jax_rmsnorm_ref(xj, wj)),
                               atol=TOL["bfloat16"])


@pytest.fixture
def seen_blocks(monkeypatch):
    """Record the ``block_rows`` that ``ops.rmsnorm`` hands the kernel's
    wrapper (the CPU's plain path does not use it)."""
    seen = []
    real = rn.rmsnorm

    def spy(x, w, *, eps, block_rows):
        seen.append(block_rows)
        return real(x, w, eps=eps, block_rows=block_rows)
    monkeypatch.setattr(rn, "rmsnorm", spy)
    yield seen
    ops.clear_tuned_blocks()


def test_block_rows_none_resolves_through_the_registry(seen_blocks):
    x = torch.from_numpy(_inputs(5, (2, 100, 64))[0])
    w = torch.ones(64)
    ops.rmsnorm(x, w)                                   # untuned: default
    ops.set_tuned_blocks("rmsnorm", (200, 64), (32,))   # the (rows, D) key
    ops.rmsnorm(x, w)                                   # exact hit
    ops.rmsnorm(x[:, :90], w)                           # nearest (180, 64)
    ops.rmsnorm(x, w, block_rows=256)                   # explicit wins
    assert seen_blocks == [rn.DEFAULT_BLOCK_ROWS, 32, 32, 256]
    assert rn.DEFAULT_BLOCK_ROWS == 128                 # the reference's


def test_rmsnorm_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="w"):
        rn.rmsnorm(x, torch.ones(7))
    with pytest.raises(TypeError, match="float16"):
        rn.rmsnorm(x.half(), torch.ones(8))
    with pytest.raises(ValueError, match="rows, D"):
        rn.rmsnorm(torch.randn(8), torch.ones(8))
    with pytest.raises(ValueError, match="block_rows"):
        rn.rmsnorm(x, torch.ones(8), block_rows=0)


def test_plain_version_is_models_rms_norm():
    x, w = (torch.from_numpy(a) for a in _inputs(6, (3, 48)))
    from repro_torch.models.common import rms_norm
    assert torch.equal(rmsnorm_ref(x, w, eps=1e-5), rms_norm(x, w, 1e-5))
