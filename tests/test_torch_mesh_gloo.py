"""The port's device meshes over two real ranks: ``torch.distributed`` with
gloo on the CPU, two processes (``torch_mesh_worker.py``) meeting through a
``FileStore`` in ``tmp_path`` (no port is opened).

What it holds, for reduced gpt-2b in 2 stages and 2 microbatches (f32):
- ``make_pipeline_train_step(mesh=...)`` on a ``(2, 1, 1)`` ``("pod",
  "data", "model")`` mesh runs its stages over the mesh's ``pod`` group: the
  step's loss and grad norm and the gradients its optimizer receives equal
  the local transport's (``torch_pipeline_parity.pipeline_grads``), rank r
  holding stage r of ``staged`` (leading dim 1) and the shared gradients
  summed over both ranks.  Tolerances as ``test_torch_pipeline_step.py``'s
  distributed check (loss rtol 1e-6) and ``torch_pipeline_parity``'s
  gradient ones (both sides f32, sums in other orders);
- each rank's staged and consts trees equal, exactly, ``to_local()`` of the
  whole staging resharded (``ckpt.reshard``) onto
  ``pipeline_shardings(staging, mesh)``, whose keys are the reference's;
- ``ckpt.reshard`` onto a ``(2,)`` ``"data"`` mesh gives each rank its rows
  of a ``("data", None)`` leaf, the whole of a replicated one, and a
  ``torch.device`` leaf as a plain tensor;
- ``Executable.stage_mesh`` of a two-stage plan (tp = dp = 1), built by
  both ranks for both stages: rank r is at ``(0, 0)`` of stage r's mesh and
  outside the other's, and stage r's ``data`` group holds rank r alone.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import generator
from repro_torch.models import build_model
from repro_torch.train.optimizer import global_norm

import torch_pipeline_parity as pp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
DIST_RTOL = 1e-6


def _tree(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = v
    return tree


def _run_ranks(tmp_path, inp):
    in_npz = str(tmp_path / "in.npz")
    np.savez(in_npz, **inp)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    worker = os.path.join(HERE, "torch_mesh_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", str(tmp_path / "store"), in_npz,
         str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]


def test_pipeline_over_a_pod_mesh_and_reshard_over_two_gloo_ranks(tmp_path):
    cfg = get_config("gpt-2b").reduced()
    params = build_model(cfg, device="cpu").init(generator(torch.device("cpu"), 3))
    batch = pp.batch(cfg, seed=5)
    inp = {"arch": "gpt-2b", "n_mb": pp.N_MB,
           **{f"p.{k}": v.numpy() for k, v in pp.items(params).items()},
           **{f"b.{k}": v for k, v in batch.items()}}
    ranks = _run_ranks(tmp_path, inp)
    st, loss, metrics, grads = pp.pipeline_grads(cfg, params, 2, batch)
    for r, out in enumerate(ranks):
        what = f"rank {r}"
        assert sorted(out["keys"]) == sorted(
            ["staged", "shared", "consts", "staged_specs", "shared_specs",
             "consts_specs"]), what
        np.testing.assert_allclose(out["m.total_loss"], loss.item(),
                                   rtol=DIST_RTOL, err_msg=what)
        np.testing.assert_allclose(out["m.grad_norm"], global_norm(grads).item(),
                                   rtol=pp.GRAD_NORM_RTOL, err_msg=what)
        mine = {k: v[r:r + 1] for k, v in pp.items(grads["staged"]).items()}
        pp.assert_close(_tree(out, "g.staged."),
                        _tree({f"s.{k}": v for k, v in mine.items()}, "s."),
                        atol=pp.GRAD_ATOL, rtol=pp.GRAD_RTOL,
                        norm_rtol=pp.GRAD_NORM_RTOL, what=f"{what} staged grads")
        pp.assert_close(_tree(out, "g.shared."), grads["shared"],
                        atol=pp.GRAD_ATOL, rtol=pp.GRAD_RTOL,
                        norm_rtol=pp.GRAD_NORM_RTOL, what=f"{what} shared grads")
        for mine_key, placed_key, whole in (("st0.", "dt.", st.staged),
                                            ("c0.", "dc.", st.consts)):
            held, local = _tree(out, mine_key), _tree(out, placed_key)
            assert pp.items(held).keys() == pp.items(whole).keys(), what
            for k, v in pp.items(whole).items():
                want = v[r:r + 1].numpy()
                np.testing.assert_array_equal(pp.items(held)[k], want, err_msg=k)
                np.testing.assert_array_equal(pp.items(local)[k], want, err_msg=k)
        rows = np.arange(24, dtype=np.float32).reshape(8, 3)
        np.testing.assert_array_equal(out["r.rows"], rows[4 * r:4 * r + 4])
        np.testing.assert_array_equal(out["r.rep"], np.arange(5, dtype=np.float32))
        np.testing.assert_array_equal(out["r.host"], np.float32(2.5))
        assert str(out["rp.rows"]) == "(Shard(dim=0),)", what
        assert str(out["rp.rep"]) == "(Replicate(),)", what
        assert str(out["rp.host"]) == "device", what
        assert out["sm.plan"].tolist() == [[1, 1], [1, 1]], what
        assert out["sm.grids"].tolist() == [[[0]], [[1]]], what
        assert out["sm.coords"][r].tolist() == [0, 0], what
        assert out["sm.coords"][1 - r].tolist() == [-1, -1], what
        assert out["sm.sum"].tolist() == [r + 1.0], what
