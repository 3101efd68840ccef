"""One rank of the port's sharded-execution checks over ``torch.distributed``
(gloo, CPU), for ``tests/test_torch_sharded_gloo_*.py``.

    python torch_sharded_worker.py RANK WORLD STORE_FILE ARCH DATA MODEL OUT_JSON

Every rank builds the reduced config of ARCH, the same params (seed 3) and
batch (numpy seed 5), and a ``(DATA, MODEL)`` ``("data", "model")`` mesh
over the two ranks.  It runs each step twice, on plain local tensors and
on DTensors placed by the reference's rules (``fitted_shardings`` of
``param_pspecs``, the batch ``Shard(0)`` over ``data``), and writes the
largest relative difference of each result (``full_tensor()`` of the
sharded side) to OUT_JSON:

- ``train.*``: one ``make_train_step`` step in 2 microbatches (each the
  reference's rows, ``train.step.microbatches``): loss, grad norm, the
  accumulated gradients its optimizer is handed and the AdamW ``mu`` /
  ``nu`` it leaves; then the AdamW update alone on DTensors from the plain
  step's gradients (``update_*``: the params, ``mu`` and ``nu`` it
  leaves); each in the default layout and again in ZeRO-1
  (``train.zero1_*``: params replicated over ``data``, the state sharded
  over it, ``layout_specs(fsdp_params=False)``); for a dense arch on the
  (2, 1) mesh also 4 microbatches of one row each (loss, grad norm);
- ``prefill.*``: ``prefill`` under ``prefill_act_rules``, its last logits
  and every cache leaf;
- ``decode.*``: one ``decode_step`` from that cache (cache length T + 4,
  position T) under ``decode_act_rules`` of the batch, its logits and the
  cache after the write, and ``make_serve_step``'s greedy tokens.

The process group meets through a ``FileStore``, so no port is opened.
"""
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.device import generator
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, modality_inputs
from repro_torch.models.common import sharded_execution
from repro_torch.models.prefill import prefill
from repro_torch.parallel import sharding as shd
from repro_torch.serve.step import make_serve_step
from repro_torch.train.optimizer import (
    OptimizerConfig, OptState, tree_leaves, tree_map,
)
from repro_torch.train.step import layout_specs, make_train_step
import repro_torch.train.step as step_mod

B, T = 4, 16


def rel(a, b) -> float:
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    b = b.full_tensor() if isinstance(b, DTensor) else b
    a, b = a.detach().double(), b.detach().double()
    if b.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / max(b.abs().max(), 1e-30))


def worst(tree_a, tree_b) -> float:
    return max(rel(x, y) for x, y in zip(tree_leaves(tree_a), tree_leaves(tree_b)))


def clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def main(rank, world, store_file, arch, n_data, n_model, out):
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    cfg = get_config(arch).reduced()
    mesh = make_mesh((n_data, n_model), ("data", "model"), device_type="cpu")
    model = build_model(cfg, use_kernels=False, device="cpu")
    params = model.init(generator(torch.device("cpu"), 3))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    extra = modality_inputs(cfg, B, generator(torch.device("cpu"), 7))
    batch = {"tokens": tokens, "labels": labels, **extra}

    def place(specs, tree):
        return tree_map(lambda sh, x: sh.distribute(x.clone()),
                        shd.fitted_shardings(mesh, specs, tree), tree)

    def place_params():
        return place(shd.param_pspecs(params), params)

    def place_batch(b, axis):
        return tree_map(lambda sh, x: sh.distribute(x),
                        shd.batch_shardings(mesh, b, axis), b)

    res = {}
    # --- train ---------------------------------------------------------
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=1)
    seen = []
    real = step_mod.make_optimizer

    def recording(cfg_):
        init, update = real(cfg_)

        def update_recording(grads, state, params, grad_norm=None):
            seen.append(tree_map(lambda g: g.detach().clone(), grads))
            return update(grads, state, params, grad_norm)
        return init, update_recording

    step_mod.make_optimizer = recording
    step, _, opt_init = make_train_step(cfg, opt_cfg, n_microbatches=2,
                                        use_kernels=False, device="cpu")
    step_mod.make_optimizer = real
    p0 = clone(params)
    s0 = opt_init(p0)
    _, _, m0 = step(p0, s0, batch)
    # the update alone, from the plain step's gradients (Adam's first step
    # divides each gradient by its own size plus eps, so from the sharded
    # step's gradients a gradient near zero could move its param either way)
    _, opt_update = real(opt_cfg)
    pu = clone(params)
    su = opt_update(clone(seen[0]), opt_init(pu), pu)[1]
    zeros = tree_map(torch.zeros_like, params)
    for name, fsdp in (("", True), ("zero1_", False)):
        pspecs, ospecs = layout_specs(shd.param_pspecs(params), fsdp_params=fsdp)

        def state(p):
            return OptState(opt_init(p).step, place(ospecs, zeros), place(ospecs, zeros))

        p1 = place(pspecs, params)
        s1 = state(p1)
        _, _, m1 = step(p1, s1, place_batch(batch, "data"))
        for k in ("total_loss", "grad_norm"):
            res[f"train.{name}{k}"] = rel(m1[k], m0[k])
        res[f"train.{name}grads"] = worst(seen[-1], seen[0])
        res[f"train.{name}mu"] = worst(s1.mu, s0.mu)
        res[f"train.{name}nu"] = worst(s1.nu, s0.nu)
        p2 = place(pspecs, params)
        s2 = opt_update(place(pspecs, seen[0]), state(p2), p2)[1]
        res[f"train.{name}update_params"] = worst(p2, pu)
        res[f"train.{name}update_mu"] = worst(s2.mu, su.mu)
        res[f"train.{name}update_nu"] = worst(s2.nu, su.nu)
    if cfg.family == "dense" and n_data == 2:
        # 4 microbatches of B = 4: one row each, replicated over data
        step4, _, _ = make_train_step(cfg, opt_cfg, n_microbatches=4,
                                      use_kernels=False, device="cpu")
        p0 = clone(params)
        _, _, m0 = step4(p0, opt_init(p0), batch)
        p1 = place_params()
        _, _, m1 = step4(p1, opt_init(p1), place_batch(batch, "data"))
        for k in ("total_loss", "grad_norm"):
            res[f"train.mb4_{k}"] = rel(m1[k], m0[k])

    # --- prefill + decode ------------------------------------------------
    feed = {"tokens": tokens, **extra}
    prules = shd.prefill_act_rules()
    last0, cache0 = prefill(cfg, params, feed, cache_len=T + 4,
                            cache_dtype=torch.float32)
    pp = place_params()
    with sharded_execution(mesh, prules):
        last1, cache1 = prefill(cfg, pp, place_batch(feed, "data"),
                                cache_len=T + 4, cache_dtype=torch.float32)
    res["prefill.logits"] = rel(last1, last0)
    res["prefill.cache"] = worst(cache1, cache0)

    nxt = torch.argmax(last0[:, -1], dim=-1, keepdim=True)
    drules = shd.decode_act_rules(B)
    lg0, cache0 = model.decode_step(params, cache0, nxt, T)
    tok = shd.NamedSharding(mesh, (drules["batch"], None)).distribute(nxt)
    with sharded_execution(mesh, drules):
        lg1, cache1 = model.decode_step(pp, cache1, tok, T)
    res["decode.logits"] = rel(lg1, lg0)
    res["decode.cache"] = worst(cache1, cache0)
    serve, _, _ = make_serve_step(cfg, use_kernels=False, device="cpu")
    t0, _ = serve(params, cache0, nxt, T + 1)
    t1, _ = serve(pp, cache1, tok, T + 1)
    res["decode.tokens_equal"] = bool(torch.equal(t1.full_tensor(), t0))
    with open(out, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store, arch, nd, nm, out = sys.argv[1:8]
    main(int(r), int(w), store, arch, int(nd), int(nm), out)
