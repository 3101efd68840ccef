"""The port's int8 gradient compression (``repro_torch.parallel.compression``)
against the JAX package's (``repro.parallel.compression``), on the CPU.

What each check holds:
- ``quantize_int8``: ``q`` and the scales bit-equal to the reference's on
  1, 255, 256, 257, 2000 and 3 x 4096 elements, an all-zero block, round
  half to even on ties, and bf16 input; ``dequantize_int8`` bit-equal too,
  into f32 and back into the leaf's dtype;
- ``compress_tree`` with error feedback: 50 steps leaf by leaf, payload and
  residual bit-equal to the reference's at every step;
- the reference's own properties (``tests/test_substrate.py``,
  ``tests/test_comm.py``) on the port: bounded error, error feedback
  tracking the true sum, compression ratio, the residual round trip;
- the wire bytes of every payload equal ``repro_torch.comm.selector.
  compressed_wire_bytes`` byte for byte.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.parallel import compression as ref
from repro_torch.comm.selector import QUANT_BLOCK, compressed_wire_bytes
from repro_torch.parallel import compression as port

torch.set_num_threads(1)

SIZES = [(1,), (255,), (256,), (257,), (2000,), (3, 4096)]


def _bits(x):
    """Raw bytes of an array, so that equality is bit equality (-0 != 0)."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.dtype.str, x.shape, x.tobytes()


def _both(g):
    """(reference (q, scale), port (q, scale)) of one f32 numpy array."""
    q, s = ref.quantize_int8(jnp.asarray(g))
    tq, ts = port.quantize_int8(torch.from_numpy(g))
    return (np.asarray(q), np.asarray(s)), (tq.numpy(), ts.numpy())


def _assert_bit_equal(a, b, what):
    assert _bits(a) == _bits(b), what


@pytest.mark.parametrize("shape", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_quantize_and_dequantize_bit_equal_reference(shape):
    g = (3.0 * np.random.default_rng(sum(shape)).standard_normal(shape)
         ).astype(np.float32)
    (q, s), (tq, ts) = _both(g)
    _assert_bit_equal(tq, q, "q")
    _assert_bit_equal(ts, s, "scale")
    deq = ref.dequantize_int8(jnp.asarray(q), jnp.asarray(s), shape)
    tdeq = port.dequantize_int8(torch.from_numpy(tq), torch.from_numpy(ts), shape)
    _assert_bit_equal(tdeq.numpy(), deq, "dequantized")
    assert tq.nbytes + ts.nbytes == compressed_wire_bytes(g.size * 4.0)


def test_all_zero_block_gets_unit_scale_as_in_reference():
    g = np.concatenate([np.zeros(256), np.linspace(-1, 1, 300)]).astype(np.float32)
    (q, s), (tq, ts) = _both(g)
    _assert_bit_equal(tq, q, "q")
    _assert_bit_equal(ts, s, "scale")
    assert ts[0] == 1.0 and not tq[0].any()


def test_ties_round_half_to_even_in_both():
    # amax 127 gives scale 1, so q is round(g) exactly
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5, -126.5],
                 np.float32)
    (q, s), (tq, ts) = _both(g)
    _assert_bit_equal(tq, q, "q")
    assert s[0] == ts[0] == 1.0
    assert tq[0, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 64, -126]


def test_bf16_input_bit_equal_reference():
    g = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    jb = jnp.asarray(g, jnp.bfloat16)
    tb = torch.from_numpy(g).to(torch.bfloat16)
    _assert_bit_equal(tb.float().numpy(), np.asarray(jb, np.float32), "input")
    q, s = ref.quantize_int8(jb)
    tq, ts = port.quantize_int8(tb)
    _assert_bit_equal(tq.numpy(), q, "q")
    _assert_bit_equal(ts.numpy(), s, "scale")
    deq = ref.dequantize_int8(q, s, g.shape, jnp.bfloat16)
    tdeq = port.dequantize_int8(tq, ts, g.shape, torch.bfloat16)
    assert tdeq.dtype == torch.bfloat16
    _assert_bit_equal(tdeq.float().numpy(), np.asarray(deq, np.float32), "deq")


def test_error_feedback_50_steps_bit_equal_reference():
    rng = np.random.default_rng(0)
    grads = {"w": (0.01 * rng.standard_normal((300, 7))).astype(np.float32),
             "blocks": {"b": (0.01 * rng.standard_normal(11)).astype(np.float32),
                        "z": np.zeros((2, 256), np.float32)}}
    jg = {"w": jnp.asarray(grads["w"]),
          "blocks": {k: jnp.asarray(v) for k, v in grads["blocks"].items()}}
    tg = {"w": torch.from_numpy(grads["w"]),
          "blocks": {k: torch.from_numpy(v) for k, v in grads["blocks"].items()}}
    jerr, terr = ref.init_error_feedback(jg), port.init_error_feedback(tg)
    paths = [("w",), ("blocks", "b"), ("blocks", "z")]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for step in range(50):
        jp, jerr = ref.compress_tree(jg, jerr)
        tp, terr = port.compress_tree(tg, terr)
        jd, td = ref.decompress_tree(jp, jg), port.decompress_tree(tp, tg)
        for path in paths:
            what = f"step {step} {'/'.join(path)}"
            (q, s), (tq, ts) = at(jp, path), at(tp, path)
            _assert_bit_equal(tq.numpy(), q, what + " q")
            _assert_bit_equal(ts.numpy(), s, what + " scale")
            _assert_bit_equal(at(terr, path).numpy(), at(jerr, path), what + " err")
            _assert_bit_equal(at(td, path).numpy(), at(jd, path), what + " deq")
        assert port.wire_bytes(tp) == sum(
            compressed_wire_bytes(at(grads, p).size * 4.0) for p in paths)


# --- the reference's own properties, on the port ------------------------------


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 2000), scale=st.floats(1e-4, 1e3))
def test_quantize_bounded_error(n, scale):
    rng = np.random.default_rng(n)
    g = torch.from_numpy((scale * rng.standard_normal(n)).astype(np.float32))
    q, s = port.quantize_int8(g)
    deq = port.dequantize_int8(q, s, g.shape)
    blockmax = float(g.abs().max())
    assert float((deq - g).abs().max()) <= blockmax / 127.0 + 1e-6


def test_error_feedback_converges():
    """With error feedback, the *running sum* of dequantized gradients tracks
    the true sum (bias cancels) — the property that preserves SGD."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.standard_normal(512).astype(np.float32)) * 0.01
    err = port.init_error_feedback({"g": g_true})
    total_deq = torch.zeros_like(g_true)
    steps = 50
    for _ in range(steps):
        payload, err = port.compress_tree({"g": g_true}, err)
        total_deq = total_deq + port.decompress_tree(payload, {"g": g_true})["g"]
    drift = float((total_deq - steps * g_true).abs().max())
    assert drift <= float(g_true.abs().max()) * 1.1  # residual bounded


def test_compression_ratio():
    g = {"g": torch.zeros(1024)}
    payload, _ = port.compress_tree(g, port.init_error_feedback(g))
    q, s = payload["g"]
    assert q.dtype == torch.int8
    assert q.numel() + s.numel() * 4 < 0.3 * g["g"].numel() * 4


def test_compressed_wire_accounting_matches_real_quantizer():
    assert port.BLOCK == ref.BLOCK == QUANT_BLOCK
    for n_elems in (256, 1000, 4096, 77777):
        g = torch.from_numpy(np.random.RandomState(0).randn(n_elems).astype(np.float32))
        q, scale = port.quantize_int8(g)
        assert port.wire_bytes({"g": (q, scale)}) == \
            compressed_wire_bytes(n_elems * 4.0)


def test_error_feedback_residual_accounting_round_trip():
    """corrected == dequantized + residual, leaf by leaf, over two steps."""
    rng = np.random.RandomState(1)
    grads = {"w": torch.from_numpy(rng.randn(300, 7).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(11).astype(np.float32))}
    err = port.init_error_feedback(grads)
    payload, new_err = port.compress_tree(grads, err)
    deq = port.decompress_tree(payload, grads)
    for k in grads:
        torch.testing.assert_close(deq[k] + new_err[k], grads[k], rtol=0, atol=1e-6)
        assert port.wire_bytes(payload[k]) == \
            compressed_wire_bytes(grads[k].numel() * 4.0)
    payload2, err2 = port.compress_tree(grads, new_err)
    deq2 = port.decompress_tree(payload2, grads)
    for k in grads:
        torch.testing.assert_close(deq2[k] + err2[k], grads[k] + new_err[k],
                                   rtol=0, atol=1e-6)
