"""One rank of the port's pipeline on DTensors over ``torch.distributed``
(gloo, CPU), for ``tests/test_torch_pipeline_sharded_*.py``.

    python torch_pipeline_sharded_worker.py RANK WORLD STORE_FILE MODE IN_NPZ OUT

``IN_NPZ`` holds the config (``arch``, ``n_layers``, ``mesh``: the sizes of
``("pod", "data", "model")``, ``n_mb``, ``steps``), the params in the
model's layout (``p.<path>``) and each step's batch (``b<step>.<key>``).
Every rank builds ``make_pipeline_train_step(mesh=...)`` of that mesh
(``use_kernels=False``, f32): stage ``pod`` on DTensors over its ``(data,
model)`` sub-mesh.

MODE ``local`` writes to OUT (JSON) the largest relative difference of
each result against the port's local two-stage pipeline
(``LocalTransport``, the same plain path) on the same params and batch,
each of this rank's tensors against the same cut
(``train.step.place_stage``) of the local run's: the loss, grad norm and
other metrics; the staged and shared gradients the optimizer is handed;
``mu`` and ``nu`` (its square root) after the step; the params after it
(``lr.*``, in units of lr); each in the default layout and in ZeRO-1
(``zero1_``: ``layout_specs(fsdp_params=False)`` of the staged and shared
specs); and the AdamW update alone on the placed tree from the local
run's gradients and grad norm (``update_``).  The embedding table's share
is apart (``bf16.*``, :func:`compare`).  Beside them, ``place.*`` counts
what the placement left on this rank: every leaf a DTensor on the
sub-mesh, its local shape ``NamedSharding(mesh, spec).shard_shape`` of the
whole leaf, its storage its own (no more than its shard, none of the
caller's), and the staged tree's local bytes the whole staged bytes over S
and each leaf's shard factor.

MODE ``steps`` takes ``steps`` steps and writes to OUT (NPZ) each step's
metrics (``m<step>.<name>``) and the stage's params after them, gathered
over the sub-mesh (``staged.<path>``, leading dim 1; ``shared.<path>``),
for the comparison with the reference's pipeline.

The process group meets through a ``FileStore``, so no port is opened.
"""
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

import repro_torch.train.step as step_mod
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.staging import build_staging
from repro_torch.train.optimizer import (
    OptimizerConfig, OptState, tree_leaves, tree_map,
)
from repro_torch.train.step import layout_specs, place_stage

from torch_pipeline_worker import flatten, unflatten

OPT = dict(lr=1e-3, warmup_steps=3, total_steps=10)
AXES = ("pod", "data", "model")


def rel(a, b) -> float:
    a = a.to_local() if isinstance(a, DTensor) else a
    b = b.to_local() if isinstance(b, DTensor) else b
    a, b = torch.as_tensor(a).detach().double(), torch.as_tensor(b).detach().double()
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / max(b.abs().max(), 1e-30))


def worst(tree_a, tree_b) -> float:
    return max(rel(x, y) for x, y in zip(tree_leaves(tree_a), tree_leaves(tree_b)))


def clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def recording(sink):
    """``make_optimizer`` whose update records (copies of) the gradients
    and grad norm it is handed before it consumes them."""
    real = step_mod.make_optimizer

    def make(cfg):
        init, update = real(cfg)

        def update_recording(grads, state, params, grad_norm=None):
            sink.append((clone(grads), grad_norm))
            return update(grads, state, params, grad_norm=grad_norm)
        return init, update_recording
    return make


def config(inp):
    cfg = get_config(str(inp["arch"])).reduced()
    n = int(inp["n_layers"])
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


def scalar(x) -> float:
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def build(inp, mesh=None, sink=None):
    """(step, staging, opt_init, shardings) of the f32 pipeline."""
    real = step_mod.make_optimizer
    if sink is not None:
        step_mod.make_optimizer = recording(sink)
    try:
        return step_mod.make_pipeline_train_step(
            config(inp), OptimizerConfig(**OPT), n_stages=int(inp["mesh"][0]),
            n_microbatches=int(inp["n_mb"]), act_dtype=torch.float32,
            params=unflatten(inp, "p."), use_kernels=False, device="cpu",
            mesh=mesh)
    finally:
        step_mod.make_optimizer = real


def placement(cfg, inp, st, specs, mesh):
    """What the placement left on this rank (``place.*``): counts that
    must be 0, and the staged bytes against the whole staging's."""
    sub = mesh["data", "model"]
    whole = build_staging(cfg, int(inp["mesh"][0]), unflatten(inp, "p."),
                          act_dtype=torch.float32)
    caller = {x.untyped_storage().data_ptr() for x in tree_leaves(whole.staged)
              + tree_leaves(whole.shared) + tree_leaves(whole.consts)}
    out = {"place.not_dtensor": 0, "place.shape_mismatch": 0,
           "place.storage_shared_or_larger": 0}
    local_bytes = want_bytes = 0
    S = int(inp["mesh"][0])
    for name in ("staged", "shared", "consts"):
        for x, w, spec in zip(tree_leaves(getattr(st, name)),
                              tree_leaves(getattr(whole, name)),
                              tree_leaves(specs[name])):
            if not (isinstance(x, DTensor) and x.device_mesh == sub):
                out["place.not_dtensor"] += 1
                continue
            loc = x.to_local()
            if tuple(loc.shape) != shd.NamedSharding(mesh, spec).shard_shape(w.shape):
                out["place.shape_mismatch"] += 1
            if (loc.untyped_storage().data_ptr() in caller
                    or loc.untyped_storage().nbytes() != loc.numel() * loc.element_size()):
                out["place.storage_shared_or_larger"] += 1
            if name == "staged":
                factor = 1
                for size, p in zip(sub.shape, x.placements):
                    factor *= size if isinstance(p, Shard) else 1
                local_bytes += loc.numel() * loc.element_size()
                want_bytes += w.numel() * w.element_size() // (S * factor)
    out["place.staged_bytes_off"] = abs(local_bytes - want_bytes)
    out["place.staged_bytes"] = local_bytes
    return out


def items(tree, path=()):
    """{"a.b": leaf} of a nested dict."""
    if not isinstance(tree, dict):
        return {".".join(path): tree}
    return {k: v for key in sorted(tree) for k, v in items(tree[key], path + (key,)).items()}


def norm_rel(a, b) -> float:
    a, b = (x.to_local().detach().double() for x in (a, b))
    return float((a - b).norm() / b.norm())


def compare(res, key, got, want):
    """``res[key]``: the largest relative difference of two
    ``{"staged", "shared"}`` trees over their leaves but the embedding
    table; ``res["bf16." + key]``: the table's relative norm difference.
    Its gradient comes back through ``make_io``'s bf16 rounding of the
    embedded input, where an f32 rounding difference in the cotangent can
    move an element by a bf16 ulp (``torch_pipeline_sharded.BF16_NORM_RTOL``)."""
    got, want = items(got), items(want)
    res[key] = max(rel(got[k], want[k]) for k in want if k != "shared.embed")
    if "shared.embed" in want:
        res[f"bf16.{key}"] = norm_rel(got["shared.embed"], want["shared.embed"])


def params_after(res, key, got, want):
    """The params after a step, the largest element's difference in units
    of lr (``res["lr." + key]``).  AdamW's first step moves a param by
    about lr times the sign of its gradient, so an f32 rounding difference
    in a gradient element near 0 moves that param by up to 2 lr
    (``test_torch_pipeline_step.py``'s bound); AdamW's arithmetic on the
    DTensors is held to 1e-5 by the update alone (``update_*``)."""
    got, want = items(got), items(want)
    res[f"lr.{key}"] = max(float((got[k].to_local() - want[k].to_local()).abs().max())
                           for k in want) / OPT["lr"]


def root(tree):
    """``nu``'s square root, in the gradient's units: the first step's
    ``nu`` is 0.05 g^2, whose relative rounding is twice the gradient's."""
    return tree_map(torch.sqrt, tree)


def run_local(inp, out_path, mesh):
    cfg = config(inp)
    batch = {k[3:]: v for k, v in inp.items() if k.startswith("b0.")}
    # the local two-stage pipeline: every stage in this process
    seen0 = []
    step0, st0, init0, _ = build(inp, sink=seen0)
    opt0 = init0({"staged": st0.staged, "shared": st0.shared})
    staged0, shared0, opt0, m0 = step0(st0.staged, st0.shared, st0.consts, opt0, batch)
    grads0, gn0 = seen0[0]
    after0 = {"staged": staged0, "shared": shared0}

    seen = []
    step, st, opt_init, shardings = build(inp, mesh=mesh, sink=seen)
    specs = {k: shardings[f"{k}_specs"] for k in ("staged", "shared", "consts")}
    res = placement(cfg, inp, st, specs, mesh)
    whole = build_staging(cfg, int(inp["mesh"][0]), unflatten(inp, "p."),
                          act_dtype=torch.float32)
    host = {"staged": whole.staged, "shared": whole.shared}
    zeros = tree_map(torch.zeros_like, host)
    _, update = step_mod.make_optimizer(OptimizerConfig(**OPT))

    def cut(tree, spec_tree):
        return place_stage(tree, spec_tree, mesh, "cpu")

    for layout, fsdp in (("", True), ("zero1_", False)):
        pspecs, ospecs = ({k: layout_specs(specs[k], fsdp_params=fsdp)[i]
                           for k in ("staged", "shared")} for i in (0, 1))

        def placed():
            tree = cut(host, pspecs)
            return tree, OptState(opt_init(tree).step, cut(zeros, ospecs),
                                  cut(zeros, ospecs))

        if fsdp:    # as the step placed it, and opt_init's state
            tree = {"staged": st.staged, "shared": st.shared}
            state = opt_init(tree)
        else:
            tree, state = placed()
        seen.clear()
        staged, shared, state, m = step(tree["staged"], tree["shared"], st.consts,
                                        state, batch)
        grads, gn = seen[0]
        for k in ("total_loss", "loss", "aux_loss", "tokens", "grad_norm", "lr"):
            res[f"train.{layout}{k}"] = rel(torch.tensor(scalar(m[k])),
                                            torch.tensor(float(m0[k])))
        res[f"train.{layout}grad_norm_handed"] = rel(torch.tensor(scalar(gn)),
                                                     torch.tensor(float(gn0)))
        want = cut(grads0, pspecs)
        compare(res, f"train.{layout}staged_grads", {"staged": grads["staged"]},
                {"staged": want["staged"]})
        compare(res, f"train.{layout}shared_grads", {"shared": grads["shared"]},
                {"shared": want["shared"]})
        params_after(res, f"train.{layout}params", {"staged": staged, "shared": shared},
                     cut(after0, pspecs))
        compare(res, f"train.{layout}mu", state.mu, cut(opt0.mu, ospecs))
        compare(res, f"train.{layout}nu", root(state.nu), root(cut(opt0.nu, ospecs)))
        # the update alone, from the local run's gradients and grad norm
        p0 = clone(host)
        s0 = update(clone(grads0), init0(p0), p0, grad_norm=gn0)[1]
        p1, s1 = placed()
        s1 = update(cut(grads0, pspecs), s1, p1, grad_norm=gn0)[1]
        compare(res, f"train.{layout}update_params", p1, cut(p0, pspecs))
        compare(res, f"train.{layout}update_mu", s1.mu, cut(s0.mu, ospecs))
        compare(res, f"train.{layout}update_nu", root(s1.nu), root(cut(s0.nu, ospecs)))
    with open(out_path, "w") as f:
        json.dump(res, f)


def run_steps(inp, out_path, mesh):
    step, st, opt_init, _ = build(inp, mesh=mesh)
    staged, shared = st.staged, st.shared
    opt = opt_init({"staged": staged, "shared": shared})
    out = {}
    for i in range(int(inp["steps"])):
        batch = {k[len(f"b{i}."):]: v for k, v in inp.items()
                 if k.startswith(f"b{i}.")}
        staged, shared, opt, m = step(staged, shared, st.consts, opt, batch)
        out.update({f"m{i}.{k}": scalar(v) for k, v in m.items()})
    flatten(tree_map(lambda x: x.full_tensor(), staged), "staged.", out)
    flatten(tree_map(lambda x: x.full_tensor(), shared), "shared.", out)
    np.savez(out_path, **out)


def main(rank, world, store_file, mode, in_npz, out_path):
    torch.set_num_threads(1)
    inp = dict(np.load(in_npz))
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(tuple(int(n) for n in inp["mesh"]), AXES, device_type="cpu")
        (run_local if mode == "local" else run_steps)(inp, out_path, mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:7])
