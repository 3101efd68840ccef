#!/usr/bin/env python3
"""Where ``make_pipeline_train_step``'s time and memory go on one CUDA card.

Run from the repository root: ``python3 scripts/torch_profile_pipeline.py``
(full-width gpt-2b, a batch of 8 x 1024 tokens from ``make_batch`` seed
0, the local transport, the AdamW that ``fit`` builds for its steps;
defaults: 2 stages, 4 microbatches, bf16 activations, 3 steps).  Prints
JSON lines:

  pipeline  per-step seconds, loss and grad norm, tokens/s over steps
            2..N, peak device memory;
  profile   torch.profiler over steps 2..N: device time by kernel and by
            class (library GEMMs, the port's kernels, the other kernels:
            casts, elementwise passes, reductions, copies), kernel launches
            per step (all of them, and the port's own ``LAUNCHES``), and the
            device's busy share of the wall time;
  phases    two more steps split by CUDA syncs into forward (the slot loop),
            backward (``autograd.grad``, every slot's recompute included)
            and optimizer (the in-place AdamW update);
  single    ``--single-steps`` steps of the single-pod ``make_train_step``
            from the same init and batches, with the same microbatches
            (gradient accumulation over ``n_microbatches``) and the same
            activation dtype: the one-card work the pipeline's schedule
            adds to (warm-up and drain slots, a head at every stage).

The Chrome trace of the profiled steps goes to ``--trace-dir`` (default
``build/traces``).  Numbers are of the card named in the ``device`` line;
nothing runs without a card.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
ARCH, BATCH = "gpt-2b", (8, 1024)

from torch_profile_fit import class_split, kernel_table  # noqa: E402
from torch_profile_generate import emit  # noqa: E402


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--act-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--single-steps", type=int, default=3)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "traces"))
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import LAUNCHES, build, reset_launches
    from repro_torch.models import common
    from repro_torch.parallel.staging import unstage
    from repro_torch.parallel.pipeline import pipeline_loss_fn
    from repro_torch.train.optimizer import (
        OptimizerConfig, make_optimizer, tree_leaves, tree_map, tree_unflatten,
    )
    from repro_torch.train.step import (
        batch_to_device, make_pipeline_train_step, make_train_step,
    )

    os.makedirs(args.trace_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi)
    t0 = time.perf_counter()
    build.build_all()                  # not inside step 1
    emit("build", seconds=time.perf_counter() - t0)

    cfg = get_config(ARCH)
    (B, T), n = BATCH, args.steps
    act = getattr(torch, args.act_dtype)
    opt_cfg = OptimizerConfig(warmup_steps=min(20, n), total_steps=n)
    step, st, opt_init, _ = make_pipeline_train_step(
        cfg, opt_cfg, n_stages=args.stages, n_microbatches=args.microbatches,
        act_dtype=act)
    staged, shared = st.staged, st.shared
    dev = shared["embed"].device
    data = DataConfig(cfg.vocab_size, T, B, 0)
    batches = [batch_to_device(make_batch(data, i), dev) for i in range(n + 2)]
    init = tree_map(lambda x: x.detach().cpu(), unstage(cfg, staged, shared))
    opt = opt_init({"staged": staged, "shared": shared})
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.reset_peak_memory_stats()
    hist = []
    for i in range(n):
        if i == 1:
            reset_launches()
            prof.start()
            t_window = time.perf_counter()
        t0 = time.perf_counter()
        staged, shared, opt, m = step(staged, shared, st.consts, opt, batches[i])
        torch.cuda.synchronize()
        hist.append({"step": i + 1, "time_s": time.perf_counter() - t0,
                     "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()})
    wall_ms = (time.perf_counter() - t_window) * 1e3
    prof.stop()
    launches = dict(LAUNCHES)
    emit("pipeline", arch=ARCH, stages=args.stages,
         microbatches=args.microbatches, batch=B, seq_len=T,
         act_dtype=args.act_dtype, steps=hist,
         tokens_per_s_steps_2_on=B * T * (n - 1) / sum(h["time_s"] for h in hist[1:]),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    busy_ms, n_kernels, top = kernel_table(prof, 15)
    prof.export_chrome_trace(os.path.join(args.trace_dir, "trace_pipeline.json"))
    emit("profile", region=f"pipeline steps 2..{n}", wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         kernel_launches_per_step=n_kernels / (n - 1),
         port_launches_per_step={k: v / (n - 1) for k, v in launches.items()},
         device_ms_per_step_by_class=class_split(prof, n - 1), top=top)
    del prof

    # ---- forward (the slot loop) / backward / optimizer ----
    loss_fn = pipeline_loss_fn(st, args.microbatches)
    _, opt_update = make_optimizer(opt_cfg)
    for i in (n, n + 1):
        out = {}

        def phase(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
            out[name] = {"s": time.perf_counter() - t0,
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
            return value

        tree = {"staged": staged, "shared": shared}
        alias = tree_map(lambda p: p.detach().requires_grad_(), tree)
        with torch.enable_grad():
            loss, _ = phase("forward", lambda: loss_fn(
                alias["staged"], alias["shared"], st.consts, batches[i]))
            leaves = tree_leaves(alias)
            grads = phase("backward", lambda: torch.autograd.grad(loss, leaves))
        del loss, alias, leaves
        gtree = tree_unflatten(tree, grads)
        del grads
        phase("optimizer", lambda: opt_update(gtree, opt, tree))
        del gtree
        free_memory()
        emit("phases", step=i + 1, **out, step_s=sum(v["s"] for v in out.values()))
    del staged, shared, opt, st, step
    free_memory()

    # ---- the single-pod step, same microbatches and activation dtype ----
    if args.single_steps:
        torch.cuda.reset_peak_memory_stats()
        step_fn, _, init_fn = make_train_step(
            cfg, opt_cfg, n_microbatches=args.microbatches)
        params = tree_map(lambda x: x.to(dev), init)
        opt_state = init_fn(params)
        steps = []
        common.set_act_dtype(act if act != torch.float32 else None)
        try:
            for i in range(args.single_steps):
                t0 = time.perf_counter()
                params, opt_state, m = step_fn(params, opt_state, batches[i])
                torch.cuda.synchronize()
                steps.append({"step": i + 1, "time_s": time.perf_counter() - t0,
                              "loss": m["loss"].item(),
                              "grad_norm": m["grad_norm"].item()})
        finally:
            common.set_act_dtype(None)
        emit("single", n_microbatches=args.microbatches, act_dtype=args.act_dtype,
             steps=steps, pipeline_losses=[h["loss"] for h in hist[:len(steps)]],
             tokens_per_s_steps_2_on=B * T * (len(steps) - 1)
             / sum(s["time_s"] for s in steps[1:]),
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return 0


if __name__ == "__main__":
    sys.exit(main())
