#!/usr/bin/env python3
"""RMSNorm kernel (K4): warps per block against ``block_rows``, on the card.

Builds ``src/repro_torch/csrc/rmsnorm.cu`` four times with ``kWarps`` (the
rows, one per warp, of each of the small blocks a row tile is spread over)
set to 2, 4, 8 and 16 (into ``build/rmsnorm_warps/``), then times each build through
the port's wrapper at the full-width hidden states (4096, 2560) and
(8192, 2560) and at kbench's ``default_shape`` (4096, 2048), f32, for
``block_rows`` 32, 64, 128 and 256, in both orders of the builds, beside
``F.rms_norm`` and the bytes bound at 3.35 TB/s.  Times are CUDA events over
50 back-to-back launches after 5 warmup launches.

Run from the repository root on a machine with an H100:
``python3 scripts/torch_rmsnorm_warps.py``.
"""
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.kernels import build, rmsnorm as rn  # noqa: E402
from repro_torch.kernels.ref import rmsnorm_ref  # noqa: E402

WARPS = (2, 4, 8, 16)
BLOCK_ROWS = (32, 64, 128, 256)
SHAPES = ((4096, 2560), (8192, 2560), (4096, 2048))


def build_variants():
    src = open(os.path.join(build.CSRC, rn.SOURCE)).read()
    out_dir = os.path.join(ROOT, "build", "rmsnorm_warps")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = build.nvcc_path()
    jobs = []
    for w in WARPS:
        variant = re.sub(r"constexpr int kWarps = \d+;",
                         f"constexpr int kWarps = {w};", src)
        cu = os.path.join(out_dir, f"rmsnorm_w{w}.cu")
        with open(cu, "w") as f:
            f.write(variant)
        so = os.path.join(out_dir, f"rmsnorm_w{w}.so")
        jobs.append((w, so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for w, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for kWarps = {w}:\n{log}")
        print(f"kWarps={w}", [ln.strip() for ln in log.splitlines()
                              if "registers" in ln])
        lib = ctypes.CDLL(so)
        fn = lib.rmsnorm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i64, i32, i64, i32,
                       ctypes.c_float, ptr]
        fn.restype = i32
        fns[w] = (lib, fn)
    return fns


def cuda_ms(fn, warmup=5, iters=50):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    fns = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn(shape[1], generator=gen, device="cuda")
        ref = rmsnorm_ref(x, w)
        bound = 4 * (2 * shape[0] * shape[1] + shape[1]) / 3.35e12 * 1e3
        for order in (WARPS, WARPS[::-1]):
            for warps in order:
                rn._fn = fns[warps]
                for br in BLOCK_ROWS:
                    y = rn.rmsnorm(x, w, block_rows=br)
                    torch.cuda.synchronize()
                    err = (y - ref).abs().max().item()
                    ms = cuda_ms(lambda: rn.rmsnorm(x, w, block_rows=br))
                    print(f"shape={shape} warps={warps} block_rows={br} "
                          f"ms={ms:.5f} share_of_bound={bound / ms:.3f} "
                          f"max_abs_err={err:.2e}")
        lib_ms = cuda_ms(lambda: torch.nn.functional.rms_norm(
            x, (shape[1],), w, 1e-6))
        print(f"shape={shape} F.rms_norm ms={lib_ms:.5f} bound_ms={bound:.5f}")
    rn._fn = None


if __name__ == "__main__":
    main()
