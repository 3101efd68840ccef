#!/usr/bin/env python3
"""Where ``repro_torch.api.generate``'s time goes on one CUDA card.

Run from the repository root: ``python3 scripts/torch_profile_generate.py``
(defaults: full-width gpt-2b, batch 8, prompt 512, 32 new tokens;
``--arch mamba2-2.7b`` profiles the SSM family).  Prints JSON lines:

  generate   ``generate``'s own prefill_s / decode_tokens_per_s for a cold
             first call and for warm repeats (same seed, same tokens);
  steps      per-step decode wall times (CUDA-synced), first vs the rest;
  profile    for one warm prefill and for ``--profile-steps`` warm decode
             steps: device time by kernel (torch.profiler), the device's
             busy share of the wall time, and launches per step.

The Chrome trace of each profiled region goes to ``--trace-dir`` (default
``build/traces``).  Numbers are of the card named in the ``device`` line;
nothing runs without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def device_time_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        val = getattr(evt, name, None)
        if val is not None:
            return float(val)
    return 0.0


def profile_region(fn, label: str, out_dir: str, top: int):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type is not None and "CUDA" in str(e.device_type)
               and device_time_us(e) > 0]
    busy_us = sum(device_time_us(e) for e in kernels)
    rows = sorted(kernels, key=device_time_us, reverse=True)[:top]
    prof.export_chrome_trace(os.path.join(out_dir, f"trace_{label}.json"))
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / (wall_s * 1e3),
        "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:90], "count": e.count,
                 "device_ms": device_time_us(e) / 1e3} for e in rows],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gpt-2b",
                    choices=["gpt-2b", "mamba2-2.7b"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--profile-steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "traces"))
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.device import generator, resolve_device
    from repro_torch.models.prefill import prefill
    from repro_torch.serve.step import greedy_tokens, make_serve_step

    out_dir = args.trace_dir
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit("device", kind=torch.cuda.get_device_name(0), nvidia_smi=smi)

    kw = dict(batch=args.batch, prompt_len=args.prompt_len,
              gen_tokens=args.gen_tokens, seed=args.seed)
    runs = [generate(args.arch, **kw) for _ in range(1 + args.repeats)]
    same = all((r["tokens"] == runs[0]["tokens"]).all() for r in runs)
    warm = runs[1:]
    emit("generate", arch=args.arch, **kw, tokens_equal_across_runs=bool(same),
         cold={k: runs[0][k] for k in ("prefill_s", "decode_s",
                                       "decode_tokens_per_s")},
         warm_prefill_s=[r["prefill_s"] for r in warm],
         warm_decode_tokens_per_s=[r["decode_tokens_per_s"] for r in warm],
         warm_median_prefill_s=statistics.median(r["prefill_s"] for r in warm),
         warm_median_decode_tokens_per_s=statistics.median(
             r["decode_tokens_per_s"] for r in warm))

    cfg = get_config(args.arch)
    dev = resolve_device(None)
    serve_step, model = make_serve_step(cfg, device=dev)
    gen = generator(dev, args.seed)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    total = args.prompt_len + args.gen_tokens
    state = {}

    def run_prefill():
        last, cache = prefill(cfg, params, {"tokens": tokens}, cache_len=total,
                              use_kernels=True)
        state["tok"], state["cache"] = greedy_tokens(last), cache

    def run_steps(start: int, n: int):
        for t in range(start, start + n):
            state["tok"], state["cache"] = serve_step(
                params, state["cache"], state["tok"], t)

    run_prefill()                      # warm
    step_ms = []
    for t in range(args.prompt_len, total - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(t, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    emit("steps", step_ms=step_ms, first_ms=step_ms[0],
         median_rest_ms=statistics.median(step_ms[1:]))

    emit("profile", region="prefill",
         **profile_region(run_prefill, "prefill", out_dir, args.top))
    start = args.prompt_len
    res = profile_region(lambda: run_steps(start, args.profile_steps),
                         "decode", out_dir, args.top)
    res["kernel_launches_per_step"] = res["kernel_launches"] / args.profile_steps
    emit("profile", region="decode", steps=args.profile_steps, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
