#!/usr/bin/env python3
"""Where ``repro_torch.api.fit``'s time and memory go on one CUDA card.

Run from the repository root: ``python3 scripts/torch_profile_fit.py``
(defaults: full-width gpt-2b, batch 8 x 1024 tokens, 3 steps, the AdamW
that ``fit`` builds; ``--arch mamba2-2.7b`` profiles the SSM family).
Prints JSON lines:

  fit      ``fit``'s own history: per-step seconds, loss and grad norm,
           tokens/s over steps 2..N, peak device memory;
  profile  torch.profiler over steps 2..N of that ``fit``: device time by
           kernel and by class (library GEMMs, the port's kernels, the other
           kernels: elementwise passes, reductions, copies), and inside the
           ``ssd_intra_vjp`` ranges (the SSD intra-chunk term's backward, the
           plain version's VJP), kernel launches per step (all of them, and
           the port's own ``LAUNCHES``), and the device's busy share of the
           wall time;
  phases   two more steps of the same model and optimizer, split by CUDA
           syncs into forward (``loss``), backward (``autograd.grad``, the
           remat recompute included) and optimizer (the in-place AdamW
           update): seconds and peak device memory of each;
  plain    ``--plain-steps`` steps from the same init and batches with
           the kernels' plain versions (``use_kernels=False``): per-step
           losses beside the kernel path's.

The Chrome trace of the profiled steps goes to ``--trace-dir`` (default
``build/traces``).  Numbers are of the card named in the ``device`` line;
nothing runs without a card.
"""
from __future__ import annotations

import argparse
import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_profile_generate import device_time_us, emit  # noqa: E402


# torch.profiler records each record_function range on the device too (a
# user annotation spanning the kernels it launched): not a kernel.
# ops.SSDIntra.backward opens this one around the VJP of the plain version
RANGES = ("ssd_intra_vjp",)


def device_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type is not None and "CUDA" in str(e.device_type)
            and device_time_us(e) > 0 and e.key not in RANGES]


def kernel_table(prof, top: int):
    kernels = device_kernels(prof)
    rows = sorted(kernels, key=device_time_us, reverse=True)[:top]
    return (sum(device_time_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels),
            [{"name": e.key[:90], "count": e.count,
              "device_ms": device_time_us(e) / 1e3} for e in rows])


GEMM_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma")
PORT_MARKS = ("flash_fwd_kernel", "flash_bwd_", "ssd_intra_kernel",
              "rmsnorm_held_kernel", "rmsnorm_two_pass_kernel")


def kernel_class(name: str) -> str:
    """gemm (a library matrix product), port (one of the port's own
    kernels) or other (elementwise passes, reductions, copies)."""
    if any(m in name for m in PORT_MARKS):
        return "port"
    if any(m in name for m in GEMM_MARKS):
        return "gemm"
    return "other"


def range_split(prof, name: str, steps: int):
    """Device ms per step inside the profiler ranges called ``name`` (the
    kernels their CPU ops launched), by kernel class, and the count of
    ranges per step."""
    def kernels(evt):
        yield from evt.kernels
        for child in evt.cpu_children:
            yield from kernels(child)
    by_class, count = {"gemm": 0.0, "port": 0.0, "other": 0.0}, 0
    for evt in prof.events():
        if evt.name == name:
            count += 1
            for k in kernels(evt):
                by_class[kernel_class(k.name)] += k.duration / 1e3
    return {"device_ms_per_step": sum(by_class.values()) / steps,
            "by_class_ms_per_step": {k: v / steps for k, v in by_class.items()},
            "ranges_per_step": count / steps}


def class_split(prof, steps: int):
    """All device ms per step by kernel class."""
    out = {"gemm": 0.0, "port": 0.0, "other": 0.0}
    for e in device_kernels(prof):
        out[kernel_class(e.key)] += device_time_us(e) / 1e3
    return {k: v / steps for k, v in out.items()}


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt-2b",
                    choices=["gpt-2b", "mamba2-2.7b"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--plain-steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "traces"))
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import HarpConfig, fit
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import (
        OptimizerConfig, make_optimizer, tree_leaves, tree_map, tree_unflatten,
    )
    from repro_torch.train.step import batch_to_device, make_train_step
    from repro_torch.train.trainer import TrainerConfig

    os.makedirs(args.trace_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi)

    cfg = get_config(args.arch)
    B, T, n = args.batch, args.seq_len, args.steps
    ckpt_dir = tempfile.mkdtemp(prefix="profile_fit_", dir=os.path.join(ROOT, "build"))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_step_time(step, dt):
        # steps 2..n inside the profiler; on_step_time runs after each step's sync
        if step == 1:
            reset_launches()
            prof.start()
            window["t0"] = time.perf_counter()
        elif step == n:
            torch.cuda.synchronize()
            window["wall_s"] = time.perf_counter() - window["t0"]
            prof.stop()
            window["launches"] = dict(LAUNCHES)

    config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
        total_steps=n, ckpt_every=n + 1, log_every=1, ckpt_dir=ckpt_dir))
    torch.cuda.reset_peak_memory_stats()
    try:
        res = fit(args.arch, config, seed=args.seed, on_step_time=on_step_time,
                  log_fn=lambda m: print(m, file=sys.stderr, flush=True))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = res["history"]
    emit("fit", arch=args.arch, batch=B, seq_len=T, steps=[
        {k: h[k] for k in ("step", "time_s", "loss", "grad_norm")} for h in hist],
        tokens_per_s_steps_2_on=B * T * (n - 1) / sum(h["time_s"] for h in hist[1:]),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    busy_ms, launches, top = kernel_table(prof, args.top)
    prof.export_chrome_trace(os.path.join(args.trace_dir, "trace_fit.json"))
    wall_ms = window["wall_s"] * 1e3
    emit("profile", region=f"fit steps 2..{n}", wall_ms=wall_ms,
         device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
         kernel_launches_per_step=launches / (n - 1),
         port_launches_per_step={k: v / (n - 1) for k, v in window["launches"].items()},
         device_ms_per_step_by_class=class_split(prof, n - 1),
         ssd_intra_vjp=range_split(prof, RANGES[0], n - 1),
         top=top)
    del prof

    # ---- forward / backward / optimizer, on the trained state ----
    params, opt_state = res["state"]["params"], res["state"]["opt_state"]
    del res
    free_memory()
    model = build_model(cfg)
    _, opt_update = make_optimizer(OptimizerConfig(
        warmup_steps=min(20, n), total_steps=n))
    data = DataConfig(cfg.vocab_size, T, B, args.seed)
    for step in (n, n + 1):
        batch = batch_to_device(make_batch(data, step), model.device)
        out = {}

        def phase(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
            out[name] = {"s": time.perf_counter() - t0,
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "mem_after_gb": torch.cuda.memory_allocated() / 1e9}
            return value

        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = phase("forward", lambda: model.loss(alias, batch))
        leaves = tree_leaves(alias)
        grads = phase("backward", lambda: torch.autograd.grad(loss, leaves))
        del loss, alias, leaves
        gtree = tree_unflatten(params, grads)
        del grads
        phase("optimizer", lambda: opt_update(gtree, opt_state, params))
        del gtree
        free_memory()
        emit("phases", step=step + 1, **out,
             step_s=sum(v["s"] for v in out.values()),
             state_gb=sum(x.numel() * x.element_size() for x in
                          tree_leaves(params) + tree_leaves(opt_state.mu)
                          + tree_leaves(opt_state.nu)) / 1e9)
    del params, opt_state
    free_memory()

    # ---- the same steps with the kernels' plain versions ----
    if args.plain_steps:
        step_fn, plain, opt_init = make_train_step(
            cfg, OptimizerConfig(warmup_steps=min(20, n), total_steps=n),
            use_kernels=False)
        params = plain.init(generator(plain.device, args.seed))
        opt_state = opt_init(params)
        losses = []
        for step in range(args.plain_steps):
            params, opt_state, m = step_fn(params, opt_state, make_batch(data, step))
            losses.append(float(m["loss"]))
        emit("plain", steps=args.plain_steps, losses=losses,
             kernel_losses=[h["loss"] for h in hist[:args.plain_steps]])
    return 0


if __name__ == "__main__":
    sys.exit(main())
