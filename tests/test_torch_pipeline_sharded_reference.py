"""``make_pipeline_train_step(mesh=...)`` of reduced gpt-2b, each stage on
DTensors over its ``(data, model)`` sub-mesh on four gloo ranks
(``torch_pipeline_sharded_worker.py``, mode ``steps``), against the
reference's ``make_pipeline_train_step`` on the same ``(2, 2, 1)`` and
``(2, 1, 2)`` ``("pod", "data", "model")`` meshes over 4 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, an ``Auto``-typed
mesh, in a subprocess), 2 steps from the reference's params and batches:
each rank's losses, grad norms and lr rtol 1e-5, and its stage's params and
the shared params after both steps within 2 lr per step of each element
and a relative norm error per leaf under 1e-4, as
``test_torch_pipeline_step.py`` holds the single-pod mesh.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_pipeline_parity as pp
from torch_pipeline_sharded import MESH_IDS, MESHES, SRC, run_ranks

LR = 1e-3
STEPS = 2
REF_B, REF_T = 4, 32

REFERENCE = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.configs import get_config
from repro.models import build_model
from repro.train.optimizer import OptimizerConfig
from repro.train.step import make_pipeline_train_step

out_path, steps, n_mb, B, T = sys.argv[1], *map(int, sys.argv[2:6])
cfg = get_config("gpt-2b").reduced()
params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
out = {}
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["p." + ".".join(x.key for x in k)] = np.asarray(v)
batches = []
for i in range(steps):
    toks = np.random.default_rng(i).integers(0, cfg.vocab_size, (B, T + 1))
    batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    out.update({f"b{i}.{k}": v for k, v in batches[-1].items()})
auto = (jax.sharding.AxisType.Auto,) * 3
for shape in ((2, 2, 1), (2, 1, 2)):
    name = "x".join(map(str, shape))
    t0 = time.perf_counter()
    mesh = jax.make_mesh(shape, ("pod", "data", "model"), axis_types=auto)
    step, st, opt_init, _ = make_pipeline_train_step(
        cfg, OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=10),
        mesh=mesh, n_stages=2, n_microbatches=n_mb, act_dtype=jnp.float32,
        params=params)
    staged, shared = st.staged, st.shared
    opt = opt_init({"staged": staged, "shared": shared})
    with set_mesh(mesh):
        f = jax.jit(step)
        for i, b in enumerate(batches):
            staged, shared, opt, m = f(staged, shared, st.consts, opt,
                                       jax.tree.map(jnp.asarray, b))
            out.update({f"{name}.m{i}.{k}": float(v) for k, v in m.items()})
    for tree_name, tree in (("staged", staged), ("shared", shared)):
        for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{name}.{tree_name}." + ".".join(x.key for x in k)] = np.asarray(v)
    out[f"{name}.seconds"] = time.perf_counter() - t0
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's pipeline train step on both meshes, in its own
    process (the host platform's device count is fixed at jax's start)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("JAX_PLATFORMS", None)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE, path, str(STEPS), str(pp.N_MB),
         str(REF_B), str(REF_T)], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = dict(np.load(path))
    print(json.dumps({"reference_subprocess_seconds": time.perf_counter() - t0,
                      **{k: float(v) for k, v in out.items()
                         if k.endswith(".seconds")}}))
    return out


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


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_reference_pipeline_on_a_sharded_mesh_matches_port(tmp_path, reference_run,
                                                           mesh):
    ref = reference_run
    name = "x".join(map(str, mesh))
    inp = {"arch": "gpt-2b", "n_layers": 0, "mesh": np.array(mesh),
           "n_mb": pp.N_MB, "steps": STEPS,
           **{k: v for k, v in ref.items() if k.startswith(("p.", "b0.", "b1."))}}
    ranks = run_ranks(tmp_path, "steps", inp)
    atol = 2 * LR * STEPS
    for r, out in enumerate(ranks):
        stage = r // (mesh[1] * mesh[2])        # the pod coordinate of rank r
        for i in range(STEPS):
            for k in ("total_loss", "loss", "grad_norm", "lr", "tokens", "aux_loss"):
                np.testing.assert_allclose(out[f"m{i}.{k}"], float(ref[f"{name}.m{i}.{k}"]),
                                           rtol=pp.LOSS_RTOL,
                                           err_msg=f"rank {r} step {i} {k}")
        want = {k: v[stage:stage + 1] for k, v in
                pp.items(_tree(ref, f"{name}.staged.")).items()}
        pp.assert_close(_tree(out, "staged."), _tree(
            {f"s.{k}": v for k, v in want.items()}, "s."), atol=atol, rtol=0,
            norm_rtol=pp.GRAD_NORM_RTOL, what=f"rank {r} staged")
        pp.assert_close(_tree(out, "shared."), _tree(ref, f"{name}.shared."),
                        atol=atol, rtol=0, norm_rtol=pp.GRAD_NORM_RTOL,
                        what=f"rank {r} shared")
