"""The port's data pipeline and checkpoints against the JAX package.

- ``make_batch`` gives the same arrays for every kind and host slice;
- checkpoints cross between the packages in both directions, bit-equal,
  with the reference's key strings (``opt_state|.step``,
  ``opt_state|.mu|blocks|...``);
- the port's checkpoint protocol behaves as ``tests/test_checkpoint.py``
  and ``tests/test_chaos.py`` hold the reference's to: the write-fault hook,
  key-hazard rejection, loud restore errors, and the async / incremental
  manifests."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.ckpt as jckpt
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import make_batch as jax_make_batch
from repro.train.optimizer import OptimizerConfig as JaxOptimizerConfig
from repro.train.optimizer import make_adamw as jax_make_adamw
import repro_torch.checkpoint.ckpt as ckpt
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.train.optimizer import OptimizerConfig, make_adamw

torch.set_num_threads(1)


# --- data -------------------------------------------------------------------


@pytest.mark.parametrize("host_slice", [None, (0, 2), (1, 2), (2, 4)])
@pytest.mark.parametrize("kind", ["zipf", "uniform", "markov"])
def test_make_batch_is_array_identical(kind, host_slice):
    for seed, step in [(0, 0), (3, 17)]:
        cfg = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed, kind=kind)
        a = make_batch(DataConfig(**cfg), step, host_slice)
        b = jax_make_batch(JaxDataConfig(**cfg), step, host_slice)
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


# --- crossing between the packages --------------------------------------------


def _train_state(opt_kw=None):
    """A reference {"params", "opt_state"} after one AdamW update, and the
    port's state with the same values (converted through numpy)."""
    rng = np.random.default_rng(0)
    params = {"embed": rng.standard_normal((16, 8), np.float32),
              "blocks": {"w": rng.standard_normal((2, 8, 8), np.float32),
                         "ln": np.ones((2, 8), np.float32)},
              "final_norm": np.ones(8, np.float32)}
    kw = opt_kw or {}
    jinit, jupdate = jax_make_adamw(JaxOptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.5, jp)
    jp, js, _ = jupdate(grads, jinit(jp), jp)
    ref = jax.tree.map(np.asarray, {"params": jp, "opt_state": js})
    tinit, _ = make_adamw(OptimizerConfig(**kw))
    tp = params_from_jax(ref["params"])
    ts = tinit(tp)
    port = {"params": tp, "opt_state": ts}
    port_from_ref = {"params": params_from_jax(ref["params"]),
                     "opt_state": type(ts)(
                         torch.from_numpy(np.array(ref["opt_state"].step)),
                         params_from_jax(ref["opt_state"].mu),
                         params_from_jax(ref["opt_state"].nu),
                         None if ref["opt_state"].master is None
                         else params_from_jax(ref["opt_state"].master))}
    return ref, port, port_from_ref


def _assert_bit_equal(flat_a, flat_b):
    assert sorted(flat_a) == sorted(flat_b)
    for k in flat_a:
        a, b = np.asarray(flat_a[k]), np.asarray(flat_b[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("master", [False, True])
def test_port_flattens_with_the_reference_keys(master):
    ref, _, port = _train_state({"master_weights": master})
    keys = sorted(ckpt._flatten(port))
    assert keys == sorted(jckpt._flatten(ref))
    assert "opt_state|.step" in keys and "opt_state|.mu|blocks|w" in keys
    assert any(k.startswith("opt_state|.master|") for k in keys) == master


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref, port, _ = _train_state()
    jckpt.save(str(tmp_path), 7, ref, extra={"data_seed": 3})
    step, tree, extra = ckpt.restore(str(tmp_path), port)
    assert step == 7 and extra == {"data_seed": 3}
    assert type(tree["opt_state"]) is type(port["opt_state"])
    _assert_bit_equal(ckpt._flatten(tree), jckpt._flatten(ref))
    # and into the live tensors of the port's state
    from repro_torch.convert import copy_into
    copy_into(port, tree)
    _assert_bit_equal(ckpt._flatten(port), jckpt._flatten(ref))
    assert port["opt_state"].step.dtype == torch.int32


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    ref, _, port = _train_state()
    ckpt.save(str(tmp_path), 9, port, extra={"data_seed": 1})
    step, tree, extra = jckpt.restore(str(tmp_path), ref)
    assert step == 9 and extra == {"data_seed": 1}
    _assert_bit_equal(jckpt._flatten(tree), ckpt._flatten(port))


def test_incremental_port_checkpoints_restore_through_the_reference(tmp_path):
    ref, _, port = _train_state()
    with ckpt.AsyncCheckpointer(str(tmp_path), keep=0, background=True) as cp:
        cp.save(1, port)
        with torch.no_grad():
            port["params"]["embed"].add_(1.0)
        cp.save(2, port)
    meta = ckpt._read_meta(str(tmp_path), 2)
    assert meta["leaves"]["params|embed"] == 2
    assert meta["leaves"]["opt_state|.mu|embed"] == 1
    with np.load(str(tmp_path / "ckpt_0000000002.npz")) as z:
        assert set(z.files) == {ckpt.META_KEY, "params|embed"}
    step, tree, _ = jckpt.restore(str(tmp_path), ref)
    assert step == 2
    _assert_bit_equal(jckpt._flatten(tree), ckpt._flatten(port))


# --- the protocol, as the reference's tests hold it ---------------------------


def _tree():
    return {"params": {"dense": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                                 "b": torch.zeros(4)},
                       "scale": np.float32(2.5)},
            "opt": [np.ones(5, dtype=np.float32), torch.full((5,), 7, dtype=torch.int32)]}


def test_save_restore_bit_identity_and_errors(tmp_path):
    d = str(tmp_path)
    assert ckpt.restore(d, _tree()) is None
    ckpt.save(d, 3, _tree(), extra={"x": 1})
    step, got, extra = ckpt.restore(d, _tree())
    assert step == 3 and extra == {"x": 1}
    _assert_bit_equal(ckpt._flatten(got), ckpt._flatten(_tree()))
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(d, {**_tree(), "extra": np.zeros(2)})
    bad = _tree()
    bad["params"]["dense"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, bad)


@pytest.mark.parametrize("hazard", ["separator", "metadata"])
def test_key_hazards_are_rejected(tmp_path, hazard):
    tree = ({"a|b": np.zeros(2)} if hazard == "separator"
            else {ckpt.META_KEY: np.zeros(2)})
    with pytest.raises(ValueError, match=hazard):
        ckpt.save(str(tmp_path), 1, tree)


@pytest.mark.parametrize("mode", ["partial", "fsync"])
def test_write_fault_keeps_previous_checkpoint_readable(tmp_path, mode):
    d = str(tmp_path / "ckpts")
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    ckpt.save(d, 1, tree)
    prev = ckpt.set_write_fault(lambda step: mode)
    try:
        with pytest.raises(IOError):
            ckpt.save(d, 2, {"w": torch.ones(8)})
    finally:
        ckpt.set_write_fault(prev)
    assert ckpt.list_steps(d) == [1]
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    step, got, _ = ckpt.restore(d, tree)
    assert step == 1
    np.testing.assert_array_equal(got["w"], np.arange(8, dtype=np.float32))
    ckpt.save(d, 2, {"w": torch.ones(8)})
    assert ckpt.list_steps(d) == [1, 2]


def test_gc_keeps_window_and_referenced_donors(tmp_path):
    a, b = torch.arange(3, dtype=torch.float32), torch.ones(2)
    with ckpt.AsyncCheckpointer(str(tmp_path), keep=2, background=False) as cp:
        for i, step in enumerate((10, 20, 30, 40)):
            cp.save(step, {"a": a + i, "b": b})
    # keep=2 leaves {30, 40}; 10 still owns b's bytes, so only 20 goes
    assert ckpt.list_steps(str(tmp_path)) == [10, 30, 40]
    with open(os.path.join(str(tmp_path), "stray.txt"), "w") as f:
        f.write("x")
    got = ckpt.restore(str(tmp_path), {"a": np.zeros(3), "b": np.zeros(2)}, step=30)
    np.testing.assert_array_equal(got[1]["b"], np.ones(2, np.float32))
    np.testing.assert_array_equal(got[1]["a"], np.arange(3, dtype=np.float32) + 2)


def test_snapshot_is_the_consistency_point_and_errors_surface(tmp_path, monkeypatch):
    t = {"a": torch.arange(4, dtype=torch.float32)}
    cp = ckpt.AsyncCheckpointer(str(tmp_path / "ok"), background=True)
    cp.save(1, t)
    t["a"][:] = -1                 # mutation after save must not reach disk
    cp.close()
    _, got, _ = ckpt.restore(str(tmp_path / "ok"), {"a": np.zeros(4)})
    np.testing.assert_array_equal(got["a"], np.arange(4, dtype=np.float32))

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "_write_atomic", boom)
    cp = ckpt.AsyncCheckpointer(str(tmp_path / "bad"), background=True)
    cp.save(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="background checkpoint"):
        cp.close()
