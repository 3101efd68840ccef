"""``make_pipeline_train_step`` of the port against the JAX package's, and
its distributed transport against its local one, on reduced gpt-2b (f32).

What each check holds, and at what tolerance:
- the reference's ``make_pipeline_train_step`` (mesh (2, 1, 1) over
  ``("pod", "data", "model")``, 2 host devices, in a subprocess: jax fixes
  the host platform's device count at its start) for 2 steps against the
  port's with the local transport: losses, grad norms and lr rtol 1e-5,
  and every parameter after them leaf for leaf: AdamW turns a rounding
  difference in a gradient element near 0 into an update difference of up
  to lr, so atol 2 lr per step, and each leaf's relative norm error under
  1e-4 (as ``torch_train_parity``; measured 1.5e-7).  The subprocess prints
  its seconds;
- the same subprocess pins a fault of the reference: its VLM stages after
  the first attend to a later microbatch's image, so its pipeline loss at
  S = 2 leaves its model's by more than 1e-3 relative; the port's matches
  the model's (module docstring of ``repro_torch.parallel.pipeline``);
- a 2-process gloo run of the distributed transport
  (``torch_pipeline_worker.py``, a ``FileStore`` in ``tmp_path``, no port)
  for 2 steps: each rank's metrics, and its staged slice and shared params,
  against the local transport's.  Losses and stage gradients are the same
  operations in the same order; the shared gradients and the grad norm are
  summed in another grouping, so metrics rtol 1e-6 and the params the AdamW
  bound above (measured bit-equal);
- a rank of a 2-stage split holds, of the staged and consts trees, copies
  of its own stage only: half the staged bytes, sharing no storage with
  the caller's params (exact), and takes its params from the caller.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.device import generator
from repro_torch.models import build_model
from repro_torch.parallel.pipeline import LocalTransport
from repro_torch.parallel.staging import build_staging
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.step import make_pipeline_train_step

import torch_pipeline_parity as pp

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=3, total_steps=10)
PARAM_ATOL_PER_STEP = 2 * LR
STEPS = 2
DIST_RTOL = 1e-6


REFERENCE = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from repro.compat import set_mesh
from repro.configs import get_config
from repro.models import build_model
from repro.parallel.pipeline import pipeline_loss_fn
from repro.parallel.staging import build_staging
from repro.train.optimizer import OptimizerConfig
from repro.train.step import make_pipeline_train_step

out_path, steps, n_mb, B, T = sys.argv[1], *map(int, sys.argv[2:6])
auto = (jax.sharding.AxisType.Auto,) * 3
mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"), axis_types=auto)
out = {}
t0 = time.perf_counter()
cfg = get_config("gpt-2b").reduced()
params = jax.jit(build_model(cfg).init)(jax.random.PRNGKey(0))
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["p." + ".".join(x.key for x in k)] = np.asarray(v)
step, st, opt_init, _ = make_pipeline_train_step(
    cfg, OptimizerConfig(lr=1e-3, warmup_steps=3, total_steps=10), mesh=mesh,
    n_stages=2, n_microbatches=n_mb, act_dtype=jnp.float32, params=params)
staged, shared = st.staged, st.shared
opt = opt_init({"staged": staged, "shared": shared})
with set_mesh(mesh):
    f = jax.jit(step)
    for i in range(steps):
        toks = np.random.default_rng(i).integers(0, cfg.vocab_size, (B, T + 1))
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out.update({f"b{i}.{k}": v for k, v in b.items()})
        staged, shared, opt, m = f(staged, shared, st.consts, opt,
                                   jax.tree.map(jnp.asarray, b))
        out.update({f"m{i}.{k}": float(v) for k, v in m.items()})
for name, tree in (("staged", staged), ("shared", shared)):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[name + "." + ".".join(x.key for x in k)] = np.asarray(v)
out["train_seconds"] = time.perf_counter() - t0

# the VLM at S = 2 against its own single-pod loss
cfg = get_config("llama-3.2-vision-90b").reduced()
model = build_model(cfg)
p = jax.jit(model.init)(jax.random.PRNGKey(0))
p["cross_blocks"] = {**p["cross_blocks"],
                     "gate_a": jnp.full_like(p["cross_blocks"]["gate_a"], 0.5),
                     "gate_m": jnp.full_like(p["cross_blocks"]["gate_m"], 0.5)}
p["embed"] = p["embed"].astype(jnp.bfloat16).astype(jnp.float32)
rng = np.random.default_rng(7)
vb = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)),
      "labels": rng.integers(0, cfg.vocab_size, (B, T)),
      "image_embeds": rng.standard_normal(
          (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)}
out.update({f"vlm.{k}": v for k, v in vb.items()})
for k, v in jax.tree_util.tree_flatten_with_path(p)[0]:
    out["vlm.p." + ".".join(x.key for x in k)] = np.asarray(v)
out["vlm.model_loss"] = float(model.loss(p, jax.tree.map(jnp.asarray, vb))[0])
vst = build_staging(cfg, 2, p, act_dtype=jnp.float32)
with set_mesh(mesh):
    out["vlm.pipeline_loss"] = float(jax.jit(pipeline_loss_fn(vst, mesh, n_mb))(
        vst.staged, vst.shared, vst.consts, jax.tree.map(jnp.asarray, vb))[0])
np.savez(out_path, **out)
"""
REF_B, REF_T = 4, 32


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's pipeline train step in its own process (the host
    platform's device count is fixed at jax's start)."""
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
    out["subprocess_seconds"] = time.perf_counter() - t0
    print(json.dumps({"reference_subprocess_seconds": out["subprocess_seconds"],
                      "reference_train_seconds": float(out["train_seconds"])}))
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


def _run_local(params_np, batches, cfg):
    step, st, opt_init, _ = make_pipeline_train_step(
        cfg, OptimizerConfig(**OPT), n_stages=2, n_microbatches=pp.N_MB,
        act_dtype=torch.float32, params=params_from_jax(params_np),
        device="cpu")
    staged, shared = st.staged, st.shared
    opt = opt_init({"staged": staged, "shared": shared})
    ms = []
    for b in batches:
        staged, shared, opt, m = step(staged, shared, st.consts, opt, b)
        ms.append({k: v.item() for k, v in m.items()})
    return staged, shared, ms


def test_reference_pipeline_train_step_matches_port(reference_run):
    ref = reference_run
    cfg = get_config("gpt-2b").reduced()
    batches = [{k: ref[f"b{i}.{k}"] for k in ("tokens", "labels")}
               for i in range(STEPS)]
    staged, shared, ms = _run_local(_tree(ref, "p."), batches, cfg)
    for i, m in enumerate(ms):
        for k in ("total_loss", "loss", "grad_norm", "lr", "tokens", "aux_loss"):
            np.testing.assert_allclose(m[k], float(ref[f"m{i}.{k}"]),
                                       rtol=pp.LOSS_RTOL, err_msg=f"step {i} {k}")
    atol = PARAM_ATOL_PER_STEP * STEPS
    pp.assert_close(staged, _tree(ref, "staged."), atol=atol, rtol=0,
                  norm_rtol=pp.GRAD_NORM_RTOL, what="staged")
    pp.assert_close(shared, _tree(ref, "shared."), atol=atol, rtol=0,
                  norm_rtol=pp.GRAD_NORM_RTOL, what="shared")


def test_reference_vlm_pipeline_misaligns_images_and_the_port_does_not(
        reference_run):
    ref = reference_run
    cfg = get_config("llama-3.2-vision-90b").reduced()
    b = {k: ref[f"vlm.{k}"] for k in ("tokens", "labels", "image_embeds")}
    model_loss, pipe_loss = float(ref["vlm.model_loss"]), float(ref["vlm.pipeline_loss"])
    assert abs(pipe_loss - model_loss) > 1e-3 * model_loss, (pipe_loss, model_loss)
    _, loss, _, _ = pp.pipeline_grads(cfg, params_from_jax(_tree(ref, "vlm.p.")),
                                         2, b)
    np.testing.assert_allclose(loss.item(), model_loss, rtol=pp.LOSS_RTOL)


def _run_ranks(tmp_path, inp):
    in_npz = str(tmp_path / "in.npz")
    np.savez(in_npz, **inp)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    worker = os.path.join(HERE, "torch_pipeline_worker.py")
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


def test_distributed_transport_matches_local_over_two_gloo_ranks(tmp_path):
    cfg = get_config("gpt-2b").reduced()
    params = build_model(cfg, device="cpu").init(generator(torch.device("cpu"), 3))
    rng = np.random.default_rng(5)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (pp.B, pp.T)),
                "labels": rng.integers(0, cfg.vocab_size, (pp.B, pp.T))}
               for _ in range(STEPS)]
    inp = {"arch": "gpt-2b", "n_mb": pp.N_MB, "steps": STEPS,
           **{f"p.{k}": v.numpy() for k, v in pp.items(params).items()},
           **{f"b{i}.{k}": v for i, b in enumerate(batches) for k, v in b.items()}}
    ranks = _run_ranks(tmp_path, inp)
    staged, shared, ms = _run_local(_tree(inp, "p."), batches, cfg)
    atol = PARAM_ATOL_PER_STEP * STEPS
    for r, out in enumerate(ranks):
        for i, m in enumerate(ms):
            for k, v in m.items():
                np.testing.assert_allclose(out[f"m{i}.{k}"], v, rtol=DIST_RTOL,
                                           err_msg=f"rank {r} step {i} {k}")
        mine = {k: v[r:r + 1] for k, v in pp.items(staged).items()}
        pp.assert_close(_tree(out, "staged."), _tree(
            {f"staged.{k}": v for k, v in mine.items()}, "staged."),
            atol=atol, rtol=0, norm_rtol=pp.GRAD_NORM_RTOL, what=f"rank {r} staged")
        pp.assert_close(_tree(out, "shared."), shared, atol=atol, rtol=0,
                      norm_rtol=pp.GRAD_NORM_RTOL, what=f"rank {r} shared")


class _SecondOfTwo(LocalTransport):
    """Stage 1 of 2, as rank 1 of a two-rank group sees it; the build reads
    no more of a transport than its ``stage_ids``."""

    def stage_ids(self, n_stages):
        return [1]


def _nbytes(tree):
    return sum(x.untyped_storage().nbytes() for x in tree_leaves(tree))


def test_a_rank_holds_only_its_stage():
    cfg = get_config("gpt-2b").reduced()
    params = build_model(cfg, device="cpu").init(generator(torch.device("cpu"), 3))
    full = build_staging(cfg, 2, params)
    _, st, _, _ = make_pipeline_train_step(
        cfg, OptimizerConfig(**OPT), n_stages=2, n_microbatches=pp.N_MB,
        params=params, device="cpu", transport=_SecondOfTwo())
    assert 2 * _nbytes(st.staged) == sum(
        x.numel() * x.element_size() for x in tree_leaves(full.staged))
    kept = {x.untyped_storage().data_ptr() for x in tree_leaves(params)}
    for tree, whole in ((st.staged, full.staged), (st.consts, full.consts)):
        for mine, all_ in zip(tree_leaves(tree), tree_leaves(whole)):
            assert mine.shape == (1, *all_.shape[1:])
            assert torch.equal(mine[0], all_[1])
            assert mine.untyped_storage().data_ptr() not in kept
            assert mine.untyped_storage().nbytes() == mine.numel() * mine.element_size()
    with pytest.raises(ValueError, match="takes the model's params from the caller"):
        make_pipeline_train_step(cfg, OptimizerConfig(**OPT), n_stages=2,
                                 n_microbatches=pp.N_MB, device="cpu",
                                 transport=_SecondOfTwo())
