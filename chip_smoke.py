#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX or of the JAX package.  Phases, one JSON line
each (``{"phase": ...}``):

  device    card name, count and ``nvidia-smi`` name / power limit;
  build     compiles every CUDA source of the port with nvcc (seconds,
            ptxas registers and spills of what this run compiled) and reads
            each flash kernel's (forward and backward) and K5's tensor-core
            instructions (HMMA, ``cuobjdump -sass``) and registers, stack and
            local memory (``cuobjdump -res-usage``) from the built library,
            so a cached build is checked too; fails on local memory or stack
            (spills) in one of them, on one without HMMA, or where the
            wrapper's size of a forward, backward or K5 block differs from
            the kernels' own;
  kernel    each kernel against its plain PyTorch version on the card, on
            the reference's flash cases plus the shapes of the serving and
            the training path: the forward in float32 (tolerance 2e-5) and
            bfloat16 (2e-2), out and lse; the backward's dq kernel (dq) and
            dk/dv kernel (dk, dv) in float32 (atol 5e-5, rtol 1e-3) and
            bfloat16 (atol 4e-3, rtol 8e-3); each with its largest error as
            a share of its element's tolerance (the worst f32 one of the
            forward is on the ``kernels`` line);
  main      ``repro_torch.api.generate("gpt-2b", batch=8, prompt_len=512,
            gen_tokens=32)`` at full width with launch counts reset just
            before and read just after (32 flash launches: one per layer);
  contract  at full width, prefill then stepwise decode (float32 cache)
            against the full forward's logits, and the forward with the
            kernel against the forward with plain attention;
  train     the training main path: ``repro_torch.api.fit("gpt-2b",
            HarpConfig(seq_len=1024, global_batch=8, trainer=...))`` for 3
            steps at full width, checkpoint at step 3, with launch counts
            reset just before and read just after (per step 64 forward
            launches, the remat recompute included, and 32 of each backward
            kernel); finite losses, step 1's loss against the plain path's
            on the same params and batch, and the checkpoint restored
            bit-equal;
  train_contract  at full width, batch 1 x 256: every gradient of ``loss``
            with the kernels against the same with plain attention;
  kernel    also the SSD intra-chunk kernel (``ssd_intra``, K5) against its
            plain version in float32 (atol 1e-4, rtol 1e-3) on the
            reference's property cases, Q = 100, mamba2-2.7b's prefill and
            training shapes (the prefill one in the model's strided layout),
            zamba2's N = 64, a ragged P > 64, a chunk whose dt span is
            above 100 (finite output), Q = 1 and Q = 65;
  main_ssm  ``generate("mamba2-2.7b", batch=8, prompt_len=512,
            gen_tokens=32)`` at full width (64 ``ssd_intra`` launches: one
            per layer in prefill; decode is the plain recurrence);
  contract_ssm  at full width, prefill then stepwise decode against the
            full forward's logits, and the forward with K5 against the
            plain forward;
  train_ssm ``fit("mamba2-2.7b", HarpConfig(seq_len=1024, global_batch=8,
            ...))`` for 3 steps at full width, no checkpoint written (128
            ``ssd_intra`` launches per step: forward and remat recompute;
            the backward is the plain oracle's VJP); finite losses, step 1's
            loss against the plain path's;
  train_contract_ssm  at full width, batch 1 x 512: every gradient of
            ``loss`` with K5 against the plain version; ``A_log``,
            ``dt_bias`` and ``in_proj`` gradients finite and non-zero;
  kernel    also the RMSNorm kernel (``rmsnorm``, K4) against its plain
            version: the reference's cases (f32 atol 1e-6, bf16 2e-2), its
            swept blocks on 256 and 200 rows (2e-5), D = 100 on one row, and
            the full-width hidden states (4096, 2560) and (8192, 2560) in f32
            (atol 1e-6, rtol 1e-6: sums of 2560 squares in other orders);
  kbench    after the model phases (each of which launches K4 0 times):
            ``kbench.collect(shapes="default")`` on the card for the three
            ops (each trial a run of calls back to back, at least 1 ms),
            ``collect_autotuned`` + ``install`` (the entry points then
            resolve to the winners), flash also swept and installed at
            gpt-2b's prefill shape (D = 80; the harness's sweep is at D = 64),
            ``bench_op`` at the main paths' full-width shapes, K4 at (4096,
            2560) also timed one call per event pair (the host share of a
            call), ``ops.flash_attention``
            at gpt-2b's prefill and gemma-2b's D = 256 with the winners still
            installed (gpt-2b's launches the tile swept at D = 80; a winner
            for another head dim that does not fit gives way to the default
            tile), the table saved and reloaded, and the
            tuned blocks cleared;
  plan      on the host, from that table: the HAPT planner on an H100 mesh
            plus the paper's A100 and V100 meshes, full gpt-2b and
            mamba2-2.7b (seq_len 1024, global_batch 64, default
            ``PlannerConfig``), with kbench off, an empty table (which must
            price exactly like off) and the card's table;
  timing    each kernel at its main path's shape (the flash forward at the
            prefill and the training shape, the backward kernels at the
            training shape, K5 at mamba2's prefill and training shapes, K4
            at the full-width hidden states) against its plain version, a
            PyTorch call that computes the same
            (``F.scaled_dot_product_attention`` and its backward,
            ``F.rms_norm``, timed only as yardsticks, never called by the
            port; none exists for K5) and the card's bound (the flash
            kernels' and K5's f32 operations at the 3xTF32 rate they run at,
            165 TFLOP/s, K5's bytes at 3.35 TB/s, which bound it;
            ``bound_simt_ms`` keeps the CUDA-core rate, 67 TFLOP/s), and K2 +
            K3 together against the library's backward,
            with the CUDA kernels that one library call runs (one
            ``torch.profiler`` pass).

Then the ``kernels`` line (K4's launches are the ``kbench`` phase's; the
model phases assert 0), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# f32 products on the tensor cores as three TF32 products each (3xTF32, the
# flash kernels' scheme): a third of the 495 TFLOP/s dense TF32 rate.  The
# flash kernels' f32 bound is taken at this rate
PEAK_3XTF32 = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# gradients: the reference's f32 gradient tolerance (tests/test_kernels.py).
# bf16: both sides sum in f32 in other orders and round once to bf16, so an
# element near a rounding boundary lands one ulp apart and no further: rtol
# 8e-3 is above one ulp (at most 2**-7 relative), atol 4e-3 one ulp in [0.5, 1)
GRAD_TOL = {"float32": (5e-5, 1e-3), "bfloat16": (4e-3, 8e-3)}
# kernels vs plain attention, per gradient leaf of full-width gpt-2b: both f32,
# summed in other orders
TRAIN_CONTRACT_TOL = 1e-4
# step 1 of fit vs the plain path's loss on the same params and batch
# (relative): f32 on both sides, other summation orders through 32 layers
STEP1_TOL = 1e-4
# prefill + stepwise decode vs the full forward at full width, f32 cache:
# the two sides sum the same products in other orders (other GEMM shapes)
# through 32 layers; the reference holds its reduced configs to 5e-4
CONTRACT_TOL = 2e-3

# (B, T, S, H, KV, D, causal, window)
FLASH_CASES = [            # the reference's tests/test_kernels.py cases
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 200, 200, 8, 2, 64, True, 0),
    (1, 256, 256, 4, 1, 32, True, 64),
    (2, 64, 192, 2, 2, 64, False, 0),
    (1, 130, 130, 2, 2, 128, True, 0),
]
GPT2B_PREFILL = (8, 512, 512, 32, 32, 80, True, 0)
GPT2B_TRAIN = (8, 1024, 1024, 32, 32, 80, True, 0)
TRAIN_STEPS = 3
# K5, the SSD intra-chunk kernel: the reference's tolerance (f32, sums in
# other orders).  Cases (B, nc, Q, H, P, N, decay): "ref" draws the
# reference's property-test log-decays a = -0.1 |N(0, 1)|; "A=-1" is mamba2
# at init, a = -dt, whose in-chunk span reaches ~200 at Q = 256; "span"
# adds 1 to dt, so the span is above 100 in every chunk
SSD_TOL = (1e-4, 1e-3)
MAMBA_PREFILL = (8, 2, 256, 80, 64, 128, "A=-1")
MAMBA_TRAIN = (8, 4, 256, 80, 64, 128, "A=-1")
SSD_CASES = [
    (1, 1, 16, 1, 8, 8, "ref"),            # the reference's property space
    (2, 3, 32, 4, 16, 16, "ref"),
    (2, 2, 16, 3, 8, 16, "ref"),
    (1, 3, 32, 2, 16, 8, "ref"),
    (2, 1, 100, 8, 64, 128, "A=-1"),       # a 100-token prompt: Q = 100
    MAMBA_PREFILL,
    MAMBA_TRAIN,
    (2, 2, 256, 112, 64, 64, "A=-1"),      # zamba2's N = 64
    (1, 2, 77, 3, 100, 33, "ref"),         # ragged P > 64 and N
    (1, 2, 256, 4, 64, 128, "span"),       # dt span above 100 in the chunk
    (1, 3, 1, 2, 8, 8, "ref"),             # a one-token chunk
    (2, 1, 65, 3, 64, 128, "A=-1"),        # one row past the first tile
]
# K4, RMSNorm.  The reference's tolerances (tests/test_kernels.py: f32 atol
# 1e-6 with numpy's default rtol 1e-7, bf16 2e-2; tests/test_kbench.py: 2e-5
# across swept blocks).  At D = 2560 the kernel and the plain version sum
# 2560 squares in other orders: their sums differ by up to ~2e-7 relative,
# which moves y by ~1e-7 relative plus one rounding, so atol 1e-6 and rtol
# 1e-7 leave no margin at |y| ~ 5; rtol 1e-6 does
RMS_TOL = {"float32": (1e-6, 1e-7), "bfloat16": (2e-2, 0.0)}
RMS_SWEEP_TOL = (2e-5, 2e-5)
RMS_WIDE_TOL = (1e-6, 1e-6)
RMS_MAIN = (4096, 2560)                    # gpt-2b / mamba2 hidden, 8 x 512
RMS_WIDE = [RMS_MAIN, (8192, 2560)]        # and 8 x 1024
KBENCH_FULL = {"rmsnorm": RMS_MAIN,
               "flash_attention": GPT2B_PREFILL[:6],
               "ssd_intra": MAMBA_PREFILL[:6]}
MAMBA_SERVE = dict(batch=8, prompt_len=512, gen_tokens=32)
MAMBA_TRAIN_BT = (8, 1024)
EXTRA_CASES = [
    GPT2B_PREFILL,                         # the serving path's shape
    (2, 512, 512, 8, 1, 256, True, 0),     # gemma-2b: MQA, D = 256
    (2, 300, 300, 4, 4, 112, True, 0),     # zamba2's D = 112
    (1, 100, 40, 2, 1, 80, True, 16),      # Tq > Tk: fully masked rows
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def kernel_resources(source: str, defines=()) -> dict:
    """Per kernel of a built library (``source`` built with ``-D``
    ``defines``): its tensor-core instructions (``hmma``, from ``cuobjdump
    -sass``: whether its products run there) and its registers, stack and
    local memory (``cuobjdump -res-usage``; ptxas spills to local memory)."""
    from repro_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    lib = str(build.library_path(source, tuple(defines)))

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, check=True).stdout
    res, name = {}, None
    for line in dump("-sass").splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            res[name] = {"hmma": 0}
        elif name is not None and "HMMA" in line:
            res[name]["hmma"] += 1
    name = None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+?):", line)
        name = m.group(1) if m else name
        fields = re.findall(r"\b(REG|STACK|SHARED|LOCAL):(\d+)", line)
        if name is not None and fields:
            res.setdefault(name, {"hmma": 0}).update(
                (k.lower(), int(v)) for k, v in fields)
    return res


def check_flash_build(res: dict) -> None:
    """Every flash kernel (forward and backward) runs HMMA and uses no local
    memory or stack, and the wrapper's size of each forward and backward
    block, which decides the tiles that launch, is the kernels' own for every
    head dim and dtype (the forward at every kbench tile)."""
    from repro_torch.kernels.flash_attention import (
        MAX_HEAD_DIM, bwd_blocks, bwd_kernel_shared_bytes, bwd_shared_bytes,
        fwd_kernel_shared_bytes, fwd_shared_bytes,
    )
    flash = {n: r for n, r in res.items() if "flash_fwd" in n or "flash_bwd" in n}
    bad = [(n, r) for n, r in flash.items()
           if not r["hmma"] or r.get("local", 1) or r.get("stack", 1)]
    dims = [(d, e) for d in range(1, MAX_HEAD_DIM + 1) for e in (4, 2)]
    sizes = [("fwd", d, e, bq, bk) for d, e in dims
             for bq in (16, 32, 64) for bk in (32, 64, 128)
             if fwd_shared_bytes(d, bq, bk, e) != fwd_kernel_shared_bytes(d, bq, bk, e)]
    sizes += [("bwd", d, e, dkv) for d, e in dims for dkv in (False, True)
              if bwd_shared_bytes(d, bwd_blocks(d)[0], e, dkv)
              != bwd_kernel_shared_bytes(d, bwd_blocks(d)[0], e, dkv)]
    missing = [k for k in ("flash_fwd", "flash_bwd") if not any(k in n for n in flash)]
    if missing or bad or sizes:
        raise SystemExit(f"flash kernels: missing {missing}; without HMMA or "
                         f"with local memory (spills) {bad}; block sizes that "
                         f"differ from the kernels' own {sizes[:10]}")


def check_ssd_build(res: dict) -> None:
    """K5's kernel runs HMMA and uses no local memory or stack, and the
    wrapper's size of a block is the kernel's own at every chunk and state
    size it takes."""
    from repro_torch.kernels.ssd_scan import (
        MAX_CHUNK, MAX_STATE, ssd_kernel_shared_bytes, ssd_shared_bytes,
    )
    bad = [(n, r) for n, r in res.items()
           if not r["hmma"] or r.get("local", 1) or r.get("stack", 1)]
    sizes = [(q, n) for q in range(1, MAX_CHUNK + 1) for n in range(1, MAX_STATE + 1)
             if ssd_shared_bytes(q, n) != ssd_kernel_shared_bytes(q, n)]
    if not res or bad or sizes:
        raise SystemExit(f"ssd_intra: kernels {list(res)}; without HMMA or with "
                         f"local memory (spills) {bad}; block sizes that differ "
                         f"from the kernel's own {sizes[:10]}")


def cuda_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
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


def visible_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, for one (batch, head)."""
    n = 0
    for q in range(T):
        hi = min(S, q + 1) if causal else S
        lo = max(0, q - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def flash_bound(case, dtype: str, kernel: str = "flash_attention_fwd"):
    """Least time for the work: each input read once, each output written
    once, 2*D operations per product per visible pair at the dtype's peak.

    forward: reads q, k, v, writes out and lse; 2 products (S, PV).
    dq:      reads q, k, v, out, do, lse, writes dq and delta; 3 (S, dP, dQ).
    dk/dv:   reads q, k, v, do, lse, delta, writes dk, dv; 4 (S, dP, dV, dK).

    All three run f32 products on the tensor cores as 3xTF32, so their f32
    peak is PEAK_3XTF32.  Also returns the operations."""
    B, T, S, H, KV, D, causal, window = case
    elem = 4 if dtype == "float32" else 2
    q_rows, kv_rows, stats = B * T * H, B * S * KV, 4 * B * H * T
    rows, products = {
        "flash_attention_fwd": (2 * q_rows + 2 * kv_rows, 2),
        "flash_attention_bwd_dq": (4 * q_rows + 2 * kv_rows, 3),
        "flash_attention_bwd_dkv": (2 * q_rows + 4 * kv_rows, 4),
    }[kernel]
    nbytes = elem * D * rows + stats * (1 if kernel == "flash_attention_fwd" else 2)
    ops = 2 * products * D * B * H * visible_pairs(T, S, causal, window)
    peak = PEAK_3XTF32 if dtype == "float32" else PEAK_FLOPS[dtype]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def library_kernel_names(fn) -> list:
    """The CUDA kernels one call of ``fn`` runs, from one ``torch.profiler``
    pass: which backend a library call took."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type is not None and "CUDA" in str(e.device_type)})


def qkv(case, dtype, gen):
    B, T, S, H, KV, D = case[:6]
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    return rnd(B, T, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D)


def check_kernel_cases(gen):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_ref

    failures, main_err, worst = [], None, (0.0, None)
    for case in FLASH_CASES + EXTRA_CASES + [GPT2B_TRAIN]:
        causal, window = case[6], case[7]
        for dtype in ("float32", "bfloat16"):
            q, k, v = qkv(case, dtype, gen)
            out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ro, rl = flash_attention_ref(q, k, v, causal=causal, window=window)
            tol = TOL[dtype]
            err_out = (out.float() - ro.float()).abs().max().item()
            fin = torch.isfinite(rl)
            same_inf = bool(torch.equal(torch.isneginf(lse), torch.isneginf(rl)))
            err_lse = (lse[fin] - rl[fin]).abs().max().item() if fin.any() else 0.0
            ok = (same_inf
                  and torch.allclose(out.float(), ro.float(), atol=tol, rtol=tol)
                  and torch.allclose(lse[fin], rl[fin], atol=tol, rtol=tol))
            # the largest error as a share of its element's tolerance
            share = max(((out.float() - ro.float()).abs()
                         / (tol + tol * ro.float().abs())).max().item(),
                        ((lse[fin] - rl[fin]).abs()
                         / (tol + tol * rl[fin].abs())).max().item() if fin.any() else 0.0)
            emit("kernel", kernel="flash_attention_fwd", case=case, dtype=dtype,
                 max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                 share_of_tol=share, neg_inf_rows_match=same_inf, tol=tol, ok=ok)
            if not ok:
                failures.append((case, dtype))
            if case == GPT2B_PREFILL and dtype == "float32":
                main_err = max(err_out, err_lse)
            if dtype == "float32" and share > worst[0]:
                worst = (share, case)
            del q, k, v, out, lse, ro, rl
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return main_err, worst


def check_bwd_kernel_cases(gen):
    """dq, dk, dv from the backward kernels against the plain backward, on
    the same inputs (the forward kernel's out and lse)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    )
    from repro_torch.kernels.ref import (
        flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
    )

    failures, errs = [], {}
    for case in FLASH_CASES + EXTRA_CASES + [GPT2B_TRAIN]:
        causal, window = case[6], case[7]
        kw = dict(causal=causal, window=window)
        for dtype in ("float32", "bfloat16"):
            q, k, v = qkv(case, dtype, gen)
            do = qkv(case, dtype, gen)[0]
            out, lse = flash_attention_fwd(q, k, v, **kw)
            dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
            dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw)
            torch.cuda.synchronize()
            rdq, rdelta = flash_attention_bwd_dq_ref(q, k, v, out, lse, do, **kw)
            rdk, rdv = flash_attention_bwd_dkv_ref(q, k, v, lse, do, rdelta, **kw)
            atol, rtol = GRAD_TOL[dtype]
            for kernel, pairs in (
                    ("flash_attention_bwd_dq", {"dq": (dq, rdq),
                                                "delta": (delta, rdelta)}),
                    ("flash_attention_bwd_dkv", {"dk": (dk, rdk), "dv": (dv, rdv)})):
                err = {n: (a.float() - b.float()).abs().max().item()
                       for n, (a, b) in pairs.items()}
                # the largest error as a share of its element's tolerance
                share = {n: ((a.float() - b.float()).abs()
                             / (atol + rtol * b.float().abs())).max().item()
                         for n, (a, b) in pairs.items()}
                ok = all(torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)
                         for a, b in pairs.values())
                emit("kernel", kernel=kernel, case=case, dtype=dtype,
                     **{f"max_abs_err_{n}": e for n, e in err.items()},
                     **{f"share_of_tol_{n}": e for n, e in share.items()},
                     atol=atol, rtol=rtol, ok=ok)
                if not ok:
                    failures.append((kernel, case, dtype))
                if case == GPT2B_TRAIN and dtype == "float32":
                    errs[kernel] = max(err.values())
            del q, k, v, do, out, lse, dq, dk, dv, rdq, rdk, rdv
    if failures:
        raise SystemExit(f"backward kernels disagree with their plain "
                         f"versions: {failures}")
    return errs


def run_main_path():
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = get_config("gpt-2b")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = generate("gpt-2b", batch=8, prompt_len=512, gen_tokens=32, seed=0)
    launches = dict(LAUNCHES)
    toks = res["tokens"]
    emit("main", arch="gpt-2b", batch=8, prompt_len=512, gen_tokens=32,
         launches=launches, tokens_shape=list(toks.shape),
         prefill_s=res["prefill_s"], decode_s=res["decode_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = {k: 0 for k in launches}
    want["flash_attention_fwd"] = cfg.n_layers
    if launches != want:
        raise SystemExit(f"expected {want} launches in gpt-2b generate, "
                         f"got {launches}")
    if toks.shape != (8, 32) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise SystemExit(f"bad tokens: shape {toks.shape}, "
                         f"range [{toks.min()}, {toks.max()}]")
    return launches


def run_contract():
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.models.prefill import prefill

    cfg = get_config("gpt-2b")
    model = build_model(cfg)                       # kernels on, cuda
    gen = generator(model.device, 1)
    params = model.init(gen)
    B, T, t0 = 2, 40, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=model.device)
    full, _ = model.forward(params, {"tokens": tokens})
    plain = build_model(cfg, use_kernels=False).forward(params, {"tokens": tokens})[0]
    finite = bool(torch.isfinite(full).all())
    kernel_vs_plain = (full - plain).abs().max().item()
    last, cache = prefill(cfg, params, {"tokens": tokens[:, :t0]}, cache_len=T,
                          cache_dtype=torch.float32, use_kernels=True)
    errs = [(last[:, 0] - full[:, t0 - 1]).abs().max().item()]
    for t in range(t0, T):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
        errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    emit("contract", arch="gpt-2b", batch=B, tokens=T, prefill_len=t0,
         logits_shape=list(full.shape), finite=finite,
         max_abs_err_decode_vs_forward=max(errs),
         max_abs_err_kernel_vs_plain_forward=kernel_vs_plain,
         tol=CONTRACT_TOL)
    if not finite or max(errs) > CONTRACT_TOL or kernel_vs_plain > CONTRACT_TOL:
        raise SystemExit("serving contract failed at full width")


def run_train():
    """The training main path at full width, through ``api.fit``."""
    from repro_torch.api import HarpConfig, fit
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.convert import to_numpy
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device
    from repro_torch.train.trainer import TrainerConfig

    cfg = get_config("gpt-2b")
    B, T, seed = GPT2B_TRAIN[0], GPT2B_TRAIN[1], 0
    # The plain path's loss of fit's first step: fit draws its params from a
    # generator seeded by `seed` and trains on make_batch(step 0)
    plain = build_model(cfg, use_kernels=False, remat=False)
    params = plain.init(generator(plain.device, seed))
    batch0 = batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, B, seed), 0),
                             plain.device)
    with torch.no_grad():
        plain_loss0 = plain.loss(params, batch0)[0].item()
    del params, batch0
    free_memory()
    mem_before_gb = torch.cuda.memory_allocated() / 1e9

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=build_dir)
    try:
        config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS, log_every=1,
            ckpt_dir=ckpt_dir))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = fit("gpt-2b", config, seed=seed,
                  log_fn=lambda m: print(m, file=sys.stderr, flush=True))
        fit_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        mem_state_gb = torch.cuda.memory_allocated() / 1e9
        hist = res["history"]
        steps = [{k: h[k] for k in ("step", "time_s", "loss", "grad_norm", "lr",
                                    "accuracy")} for h in hist]
        tok_s = 2 * B * T / (hist[1]["time_s"] + hist[2]["time_s"])
        # the step-3 checkpoint, restored through ckpt.restore
        t1 = time.perf_counter()
        restored = ckpt.restore(ckpt_dir, res["state"])
        restore_s = time.perf_counter() - t1
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                         for f in os.listdir(ckpt_dir))
        step_restored, tree = restored[0], restored[1]
        live = res["state"]["params"]
        bit_equal = all(np.array_equal(to_numpy(leaf), _get(tree["params"], path))
                        for path, leaf in _leaves(live))
        del tree, restored, res, live
        free_memory()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    want = {"flash_attention_fwd": 2 * cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "flash_attention_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
            "ssd_intra": 0, "rmsnorm": 0}
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    step1_rel = abs(hist[0]["loss"] - plain_loss0) / abs(plain_loss0)
    emit("train", arch="gpt-2b", batch=B, seq_len=T, steps=steps,
         launches=launches, launches_expected=want,
         tokens_per_s_steps_2_3=tok_s, fit_s=fit_s, peak_mem_gb=peak_gb,
         mem_allocated_gb={"before_fit": mem_before_gb, "after_fit": mem_state_gb,
                           "after_release": torch.cuda.memory_allocated() / 1e9},
         step1_loss=hist[0]["loss"], plain_loss_step1=plain_loss0,
         step1_rel_err=step1_rel, step1_tol=STEP1_TOL,
         step1_loss_minus_ln_vocab=hist[0]["loss"] - math.log(cfg.vocab_size),
         ckpt_step=step_restored, ckpt_bytes=ckpt_bytes, restore_s=restore_s,
         ckpt_params_bit_equal=bit_equal, finite=finite)
    if len(hist) != TRAIN_STEPS or not finite:
        raise SystemExit(f"training did not give {TRAIN_STEPS} finite steps")
    if launches != want:
        raise SystemExit(f"training launches {launches}, expected {want}")
    if step1_rel > STEP1_TOL:
        raise SystemExit(f"step 1 loss {hist[0]['loss']} vs the plain path's "
                         f"{plain_loss0}")
    if step_restored != TRAIN_STEPS or not bit_equal:
        raise SystemExit("the step-3 checkpoint did not restore bit-equal")
    return launches, {"tokens_per_s": tok_s, "peak_mem_gb": peak_gb}


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def run_train_contract():
    """Every gradient of the loss with the kernels against plain attention,
    at full width (batch 1 x 256)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, value_and_grad

    cfg = get_config("gpt-2b")
    kern = build_model(cfg)                               # kernels on, remat
    plain = build_model(cfg, use_kernels=False)
    params = kern.init(generator(kern.device, 2))
    batch = batch_to_device(make_batch(DataConfig(cfg.vocab_size, 256, 1, 2), 0),
                            kern.device)
    loss_k, _, g_k = value_and_grad(kern.loss, params, batch)
    loss_p, _, g_p = value_and_grad(plain.loss, params, batch)
    rel, dead = {}, []
    for (path, a), (_, b) in zip(_leaves(g_k), _leaves(g_p)):
        name = ".".join(path)
        rel[name] = ((a - b).norm() / b.norm()).item()
        if path[-1] in ("wq", "wk", "wv") and not bool(a.abs().sum() > 0):
            dead.append(name)
    worst = max(rel.values())
    emit("train_contract", arch="gpt-2b", batch=1, seq_len=256,
         loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
         rel_grad_err=rel, max_rel_grad_err=worst, tol=TRAIN_CONTRACT_TOL,
         zero_attention_grads=dead)
    del g_k, g_p, params
    free_memory()
    if dead or worst > TRAIN_CONTRACT_TOL:
        raise SystemExit(f"training contract failed: max rel err {worst}, "
                         f"zero gradients {dead}")


def run_timing(gen):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
    )
    from repro_torch.kernels.ref import (
        flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
        flash_attention_ref,
    )

    rows = {}
    for case, dtype in [(c, d) for c in (GPT2B_PREFILL, GPT2B_TRAIN)
                        for d in ("float32", "bfloat16")]:
        kw = dict(causal=case[6], window=case[7])
        q, k, v = qkv(case, dtype, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        timed = {"flash_attention_fwd": (
            lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: flash_attention_ref(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=kw["causal"]),
            "F.scaled_dot_product_attention")}
        if case == GPT2B_TRAIN:
            do = qkv(case, dtype, gen)[0]
            out, lse = flash_attention_fwd(q, k, v, **kw)
            _, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
            # yardstick: SDPA's backward (dq, dk, dv together), its forward
            # outside the timed region
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            ot = F.scaled_dot_product_attention(qg, kg, vg, is_causal=kw["causal"])
            dot = do.transpose(1, 2).contiguous()

            def library_bwd():
                torch.autograd.grad(ot, (qg, kg, vg), dot, retain_graph=True)
            timed["flash_attention_bwd_dq"] = (
                lambda: flash_attention_bwd_dq(q, k, v, out, lse, do, **kw),
                lambda: flash_attention_bwd_dq_ref(q, k, v, out, lse, do, **kw),
                library_bwd, "SDPA backward (dq, dk, dv together)")
            timed["flash_attention_bwd_dkv"] = (
                lambda: flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw),
                lambda: flash_attention_bwd_dkv_ref(q, k, v, lse, do, delta, **kw),
                library_bwd, "SDPA backward (dq, dk, dv together)")
        for kernel, (fn, plain, library, library_call) in timed.items():
            # plain before and after the kernel, so drift shows
            plain_a = cuda_ms(plain, warmup=1, iters=3)
            kernel_ms = cuda_ms(fn)
            library_ms = cuda_ms(library)
            plain_b = cuda_ms(plain, warmup=1, iters=3)
            bound_ms, bound_by, ops = flash_bound(case, dtype, kernel)
            row = dict(case=case, ms=kernel_ms, plain_ms=(plain_a + plain_b) / 2,
                       library_ms=library_ms, library_call=library_call,
                       bound_ms=bound_ms, bound_by=bound_by)
            if dtype == "float32":
                # the bound on the CUDA cores, where these kernels ran until
                # they moved to the tensor cores
                row["bound_simt_ms"] = ops / PEAK_FLOPS[dtype] * 1e3
            rows[(kernel, case, dtype)] = row
            emit("timing", kernel=kernel, dtype=dtype, **row,
                 plain_ms_first=plain_a, plain_ms_last=plain_b,
                 share_of_bound=bound_ms / kernel_ms)
        if case == GPT2B_TRAIN:
            k2 = rows[("flash_attention_bwd_dq", case, dtype)]
            k3 = rows[("flash_attention_bwd_dkv", case, dtype)]
            emit("timing", kernel="flash_attention_bwd (K2 + K3)", dtype=dtype,
                 case=case, k2_plus_k3_ms=k2["ms"] + k3["ms"],
                 library_ms=k3["library_ms"], library_call=k3["library_call"],
                 library_over_k2_plus_k3=k3["library_ms"] / (k2["ms"] + k3["ms"]),
                 library_kernels=library_kernel_names(library_bwd))
            del out, lse, delta, qg, kg, vg, ot, dot, library_bwd
        del timed, q, k, v, qt, kt, vt
        free_memory()
    return rows

# ---------------------------------------------------------------------------
# The SSM family: kernel K5 and mamba2-2.7b's main paths
# ---------------------------------------------------------------------------


def ssd_inputs(case, gen, strided=False):
    """(xc, dtc, cum, Bc, Cc) on the card.  ``strided``: x, B and C are the
    chunked views of one fused xBC tensor, as ``ssd_chunked`` hands them to
    the kernel."""
    B, nc, Q, H, P, N, decay = case

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if strided:
        xbc = rnd(B, nc, Q, H * P + 2 * N)
        x = xbc[..., :H * P].reshape(B, nc, Q, H, P)
        Bm, Cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x, Bm, Cm = rnd(B, nc, Q, H, P), rnd(B, nc, Q, N), rnd(B, nc, Q, N)
    dt = torch.nn.functional.softplus(rnd(B, nc, Q, H))
    if decay == "span":
        dt = dt + 1.0
    a = -0.1 * rnd(B, nc, Q, H).abs() if decay == "ref" else -dt
    return x, dt, torch.cumsum(a, dim=2), Bm, Cm


def ssd_bound(case):
    """Least time for K5's work: x, dt, cum, B, C read once and y written
    once; Q(Q+1)/2 * (2N + 2PH) operations per (b, c) (C B^T once, M x per
    head) at the 3xTF32 rate K5 runs its f32 products at (the CUDA-core
    rate's bound is ``ops / PEAK_FLOPS["float32"]``).  Also returns the
    operations."""
    B, nc, Q, H, P, N = case[:6]
    nbytes = 4 * B * nc * Q * (2 * H * P + 2 * H + 2 * N)
    ops = B * nc * Q * (Q + 1) // 2 * (2 * N + 2 * P * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_3XTF32
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", ops)


def check_ssd_cases(gen):
    from repro_torch.kernels.ref import ssd_intra_oracle
    from repro_torch.kernels.ssd_scan import ssd_intra

    atol, rtol = SSD_TOL
    failures, errs = [], {}
    for case in SSD_CASES:
        inputs = ssd_inputs(case, gen, strided=case == MAMBA_PREFILL)
        y = ssd_intra(*inputs)
        torch.cuda.synchronize()
        ref = ssd_intra_oracle(*inputs)
        cum = inputs[2]
        span = (cum[:, :, 0] - cum[:, :, -1]).max().item()
        finite = bool(torch.isfinite(y).all())
        err = (y - ref).abs().max().item()
        # the largest error as a share of its element's tolerance
        share = ((y - ref).abs() / (atol + rtol * ref.abs())).max().item()
        ok = finite and torch.allclose(y, ref, atol=atol, rtol=rtol)
        emit("kernel", kernel="ssd_intra", case=case, dtype="float32",
             strided=case == MAMBA_PREFILL, max_abs_err=err,
             max_abs_ref=ref.abs().max().item(), share_of_tol=share,
             max_cum_span=span, finite=finite, atol=atol, rtol=rtol, ok=ok)
        if not ok or (case[6] == "span" and span <= 100):
            failures.append(case)
        errs[case] = err
        del inputs, y, ref
    if failures:
        raise SystemExit(f"ssd_intra disagrees with its plain version: {failures}")
    return errs


def run_main_ssm():
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = get_config("mamba2-2.7b")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = generate("mamba2-2.7b", seed=0, **MAMBA_SERVE)
    launches = dict(LAUNCHES)
    toks = res["tokens"]
    emit("main_ssm", arch="mamba2-2.7b", **MAMBA_SERVE, launches=launches,
         tokens_shape=list(toks.shape), prefill_s=res["prefill_s"],
         decode_s=res["decode_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = {k: 0 for k in launches}
    want["ssd_intra"] = cfg.n_layers
    if launches != want:
        raise SystemExit(f"expected {want} launches in mamba2 generate, "
                         f"got {launches}")
    shape = (MAMBA_SERVE["batch"], MAMBA_SERVE["gen_tokens"])
    if toks.shape != shape or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise SystemExit(f"bad tokens: shape {toks.shape}, "
                         f"range [{toks.min()}, {toks.max()}]")
    return launches


def run_contract_ssm():
    """Prefill (two chunks: 290 tokens at chunk 256) plus stepwise decode
    against the full forward over 300 tokens, and the forward through K5
    against the plain forward, at full width."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.models.prefill import prefill

    cfg = get_config("mamba2-2.7b")
    model = build_model(cfg)                       # kernels on, cuda
    gen = generator(model.device, 1)
    params = model.init(gen)
    B, T, t0 = 2, 300, 290
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=model.device)
    full, _ = model.forward(params, {"tokens": tokens})
    plain = build_model(cfg, use_kernels=False).forward(params, {"tokens": tokens})[0]
    finite = bool(torch.isfinite(full).all())
    kernel_vs_plain = (full - plain).abs().max().item()
    last, states = prefill(cfg, params, {"tokens": tokens[:, :t0]}, cache_len=T,
                           use_kernels=True)
    errs = [(last[:, 0] - full[:, t0 - 1]).abs().max().item()]
    for t in range(t0, T):
        lg, states = model.decode_step(params, states, tokens[:, t:t + 1], t)
        errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    emit("contract_ssm", arch="mamba2-2.7b", batch=B, tokens=T, prefill_len=t0,
         logits_shape=list(full.shape), finite=finite,
         state_shapes={k: list(v.shape) for k, v in states.items()},
         max_abs_logit=full.abs().max().item(),
         max_abs_err_decode_vs_forward=max(errs),
         max_abs_err_kernel_vs_plain_forward=kernel_vs_plain, tol=CONTRACT_TOL)
    del params, full, plain, states
    free_memory()
    if not finite or max(errs) > CONTRACT_TOL or kernel_vs_plain > CONTRACT_TOL:
        raise SystemExit("ssm serving contract failed at full width")


def run_train_ssm():
    """mamba2-2.7b's training main path at full width, through ``api.fit``;
    no checkpoint is written (``ckpt_every`` above the step count)."""
    from repro_torch.api import HarpConfig, fit
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device
    from repro_torch.train.trainer import TrainerConfig

    cfg = get_config("mamba2-2.7b")
    (B, T), seed = MAMBA_TRAIN_BT, 0
    plain = build_model(cfg, use_kernels=False, remat=False)
    params = plain.init(generator(plain.device, seed))
    batch0 = batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, B, seed), 0),
                             plain.device)
    with torch.no_grad():
        plain_loss0 = plain.loss(params, batch0)[0].item()
    del params, batch0
    free_memory()
    mem_before_gb = torch.cuda.memory_allocated() / 1e9

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_ssm_", dir=build_dir)
    try:
        config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=1000, log_every=1,
            ckpt_dir=ckpt_dir))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = fit("mamba2-2.7b", config, seed=seed,
                  log_fn=lambda m: print(m, file=sys.stderr, flush=True))
        fit_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        written = os.listdir(ckpt_dir)
        del res["state"]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_memory()
    hist = res["history"]
    steps = [{k: h[k] for k in ("step", "time_s", "loss", "grad_norm", "lr",
                                "accuracy")} for h in hist]
    step_s = [h["time_s"] for h in hist]
    tok_s = 2 * B * T / (step_s[1] + step_s[2])
    want = {k: 0 for k in launches}
    want["ssd_intra"] = 2 * cfg.n_layers * TRAIN_STEPS
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    step1_rel = abs(hist[0]["loss"] - plain_loss0) / abs(plain_loss0)
    emit("train_ssm", arch="mamba2-2.7b", batch=B, seq_len=T, steps=steps,
         launches=launches, launches_expected=want,
         launches_per_step=launches["ssd_intra"] / TRAIN_STEPS, step_s=step_s,
         tokens_per_s_steps_2_3=tok_s, fit_s=fit_s, peak_mem_gb=peak_gb,
         mem_allocated_gb={"before_fit": mem_before_gb,
                           "after_release": torch.cuda.memory_allocated() / 1e9},
         step1_loss=hist[0]["loss"], plain_loss_step1=plain_loss0,
         step1_rel_err=step1_rel, step1_tol=STEP1_TOL,
         checkpoint_files=written, finite=finite)
    if len(hist) != TRAIN_STEPS or not finite:
        raise SystemExit(f"ssm training did not give {TRAIN_STEPS} finite steps")
    if launches != want:
        raise SystemExit(f"ssm training launches {launches}, expected {want}")
    if step1_rel > STEP1_TOL:
        raise SystemExit(f"ssm step 1 loss {hist[0]['loss']} vs the plain "
                         f"path's {plain_loss0}")
    if written:
        raise SystemExit(f"ssm training wrote a checkpoint: {written}")
    return launches, {"step_s": step_s, "tokens_per_s": tok_s,
                      "peak_mem_gb": peak_gb}


def run_train_contract_ssm():
    """Every gradient of the loss with K5 against the plain version, at
    full width (batch 1 x 512: two chunks of 256)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, value_and_grad

    cfg = get_config("mamba2-2.7b")
    kern = build_model(cfg)                               # kernels on, remat
    plain = build_model(cfg, use_kernels=False)
    params = kern.init(generator(kern.device, 2))
    batch = batch_to_device(make_batch(DataConfig(cfg.vocab_size, 512, 1, 2), 0),
                            kern.device)
    loss_k, _, g_k = value_and_grad(kern.loss, params, batch)
    loss_p, _, g_p = value_and_grad(plain.loss, params, batch)
    rel, bad = {}, []
    for (path, a), (_, b) in zip(_leaves(g_k), _leaves(g_p)):
        name = ".".join(path)
        rel[name] = ((a - b).norm() / b.norm()).item()
        if not bool(torch.isfinite(a).all()):
            bad.append(f"{name} not finite")
        if path[-1] in ("A_log", "dt_bias", "in_proj") and not bool(a.abs().sum() > 0):
            bad.append(f"{name} zero")
    worst = max(rel.values())
    emit("train_contract_ssm", arch="mamba2-2.7b", batch=1, seq_len=512,
         loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
         rel_grad_err=rel, max_rel_grad_err=worst, tol=TRAIN_CONTRACT_TOL,
         bad_grads=bad)
    del g_k, g_p, params
    free_memory()
    if bad or worst > TRAIN_CONTRACT_TOL:
        raise SystemExit(f"ssm training contract failed: max rel err {worst}, "
                         f"{bad}")


def run_timing_ssd(gen):
    from repro_torch.kernels.ref import ssd_intra_oracle
    from repro_torch.kernels.ssd_scan import ssd_intra

    rows = {}
    for case in (MAMBA_PREFILL, MAMBA_TRAIN):
        inputs = ssd_inputs(case, gen, strided=True)
        plain_a = cuda_ms(lambda: ssd_intra_oracle(*inputs), warmup=1, iters=3)
        kernel_ms = cuda_ms(lambda: ssd_intra(*inputs))
        plain_b = cuda_ms(lambda: ssd_intra_oracle(*inputs), warmup=1, iters=3)
        bound_ms, bound_by, ops = ssd_bound(case)
        row = dict(case=case, ms=kernel_ms, plain_ms=(plain_a + plain_b) / 2,
                   library_ms=None,
                   library_call="none: two masked matmuls with a decay",
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_simt_ms=ops / PEAK_FLOPS["float32"] * 1e3)
        rows[case] = row
        emit("timing", kernel="ssd_intra", dtype="float32", **row,
             plain_ms_first=plain_a, plain_ms_last=plain_b,
             share_of_bound=bound_ms / kernel_ms)
        del inputs
        free_memory()
    return rows


# ---------------------------------------------------------------------------
# K4 (RMSNorm), kbench on the card and the planner priced from its table
# ---------------------------------------------------------------------------


def rms_inputs(shape, dtype, gen, w_scale=0.1):
    x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
    w = 1 + w_scale * torch.randn(shape[-1:], generator=gen, device="cuda")
    return x, w


def rms_bound(shape):
    """Least time for K4's work: x read once, y written once, w read once
    (f32), 4 operations per element at the f32 rate."""
    rows, D = shape
    nbytes = 4 * (2 * rows * D + D)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 4 * rows * D / PEAK_FLOPS["float32"]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_rmsnorm_cases(gen):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rmsnorm_ref

    # (shape, dtype, block_rows, w_scale, (atol, rtol))
    cases = [(shape, dtype, None, 0.1, RMS_TOL[dtype])
             for shape in ((4, 64), (3, 5, 128), (128, 256))
             for dtype in ("float32", "bfloat16")]
    cases += [((rows, 128), "float32", br, 1.0, RMS_SWEEP_TOL)
              for rows in (256, 200) for br in (32, 64, 256)]
    cases += [((1, 100), "float32", None, 0.1, RMS_TOL["float32"])]
    cases += [(shape, "float32", None, 0.1, RMS_WIDE_TOL) for shape in RMS_WIDE]
    failures, errs = [], {}
    for shape, dtype, br, w_scale, (atol, rtol) in cases:
        x, w = rms_inputs(shape, dtype, gen, w_scale)
        y = ops.rmsnorm(x, w, block_rows=br)
        torch.cuda.synchronize()
        ref = rmsnorm_ref(x, w)
        err = (y.float() - ref.float()).abs().max().item()
        ok = (y.dtype == x.dtype and bool(torch.isfinite(y).all())
              and torch.allclose(y.float(), ref.float(), atol=atol, rtol=rtol))
        emit("kernel", kernel="rmsnorm", case=list(shape), dtype=dtype,
             block_rows=br, max_abs_err=err, atol=atol, rtol=rtol, ok=ok)
        if not ok:
            failures.append((shape, dtype, br))
        if br is None and dtype == "float32":
            errs[tuple(shape)] = err
        del x, w, y, ref
    if failures:
        raise SystemExit(f"rmsnorm disagrees with its plain version: {failures}")
    return errs


def sweep_flash_main_shape(trials: int, warmup: int):
    """``autotune.sweep`` of ``flash_attention`` at gpt-2b's prefill shape
    (D = 80, ``KBENCH_FULL``), its winner installed in the tuned-block
    registry and returned as a table cell with the sweep.  The harness sweeps
    flash at its D = 64 shape only, and the registry's nearest shape would
    carry that winner to D = 80, where it can be the slower tile."""
    from repro_torch.kbench import autotune, harness
    from repro_torch.kbench.table import LatencyTable
    shape = KBENCH_FULL["flash_attention"]
    sw = autotune.sweep("flash_attention", shape, trials=trials, warmup=warmup)
    cell = LatencyTable()
    cell.add(harness.measurement(harness.BenchResult(
        op=sw.op, shape=sw.shape, blocks=sw.best_blocks, median_s=sw.best_s,
        trials_s=(sw.best_s,) * trials, flops=harness.OPS[sw.op].flops(shape),
        device=sw.device)))
    if autotune.install(cell) != 1:
        raise SystemExit(f"the D = 80 flash winner {sw.best_blocks} was not installed")
    return cell, sw


def run_kbench():
    """kbench on the card: canonical collect, autotune + install, the main
    paths' full-width shapes, and the table's round trip."""
    from repro_torch.kbench import autotune, harness
    from repro_torch.kbench.table import LatencyTable
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.kernels.ref import flash_attention_ref

    trials, warmup = 20, 3
    fp = harness.device_fingerprint()
    kernel_of = {"flash_attention": "flash_attention_fwd", "rmsnorm": "rmsnorm",
                 "ssd_intra": "ssd_intra"}
    reset_launches()
    t0 = time.perf_counter()
    # 1. the canonical collect: each op's launches grow by warmup, the calls
    # that size a trial, and trials x those calls
    table = LatencyTable()
    grew = {}
    for op in sorted(harness.OPS):
        before = LAUNCHES[kernel_of[op]]
        table = table.merge(harness.collect([op], shapes="default",
                                            trials=trials, warmup=warmup))
        grew[op] = LAUNCHES[kernel_of[op]] - before
    collected = list(table.entries)
    # 2. the autotuner's winners, installed into the entry points' registry
    tuned, sweeps = autotune.collect_autotuned(shapes="default", trials=trials,
                                               warmup=warmup)
    n_installed = autotune.install(tuned)
    # and flash at the main paths' D = 80, so that gpt-2b's shape resolves to
    # a tile swept there, not to the D = 64 winner
    main_flash, sw80 = sweep_flash_main_shape(trials, warmup)
    tuned = tuned.merge(main_flash)
    sweeps.append(sw80)
    n_installed += 1
    resolved = [{"op": sw.op, "shape": list(sw.shape),
                 "blocks": ops.tuned_blocks(sw.op, sw.shape)} for sw in sweeps]
    x, w = rms_inputs(harness.OPS["rmsnorm"].default_shape, "float32",
                      torch.Generator(device="cuda").manual_seed(3))
    before = LAUNCHES["rmsnorm"]
    ops.rmsnorm(x, w)                  # block_rows=None -> the winner
    torch.cuda.synchronize()
    tuned_call_launched = LAUNCHES["rmsnorm"] - before
    del x, w
    # 3. the main paths' full-width shapes, at the blocks the entry points
    # resolve to with the winners installed
    full = []
    for op, shape in sorted(KBENCH_FULL.items()):
        blocks = (ops.flash_blocks(shape) if op == "flash_attention"
                  else ops.tuned_blocks(op, shape) or harness.OPS[op].default_blocks(shape))
        full.append(harness.measurement(harness.bench_op(
            op, shape, blocks=blocks, trials=trials, warmup=warmup)))
        table.add(full[-1])
    table = table.merge(tuned)
    # K4 at the hidden states both ways: trials of one call between their own
    # event pair (the host time of a call inside every sample, as kbench
    # timed before) and kbench's back-to-back trials (the full-width cell)
    x, w = rms_inputs(RMS_MAIN, "float32", torch.Generator(device="cuda").manual_seed(4))
    k4_blocks = ops.tuned_blocks("rmsnorm", RMS_MAIN) or (None,)
    k4_per_call = statistics.median(harness.trial_seconds(
        lambda: ops.rmsnorm(x, w, block_rows=k4_blocks[0]), trials, 1)) * 1e3
    k4_b2b = next(e.median_s for e in full if e.op == "rmsnorm") * 1e3
    del x, w
    # 4. the entry point at the attention shapes of gpt-2b's prefill and
    # gemma-2b (D = 256) with the winners still installed: the nearest winner
    # may be for another head dim, and a tile the kernel does not take there
    # gives way to the default; one launch each, held to the plain version
    gen = torch.Generator(device="cuda").manual_seed(5)
    resolved_calls = []
    for case in (GPT2B_PREFILL, EXTRA_CASES[1]):
        shape = case[:6]
        q, k, v = qkv(case, "float32", gen)
        before = LAUNCHES["flash_attention_fwd"]
        out = ops.flash_attention(q, k, v, causal=case[6], window=case[7])
        torch.cuda.synchronize()
        n = LAUNCHES["flash_attention_fwd"] - before
        ro = flash_attention_ref(q, k, v, causal=case[6], window=case[7])[0]
        err = (out - ro).abs().max().item()
        resolved_calls.append({
            "shape": list(shape), "nearest_winner": ops.tuned_blocks("flash_attention", shape),
            "launched_blocks": ops.flash_blocks(shape), "launches": n,
            "max_abs_err": err,
            "ok": n == 1 and torch.allclose(out, ro, atol=TOL["float32"], rtol=TOL["float32"])})
        del q, k, v, out, ro
    # 5. save, reload, compare
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="kbench_", suffix=".json", dir=build_dir)
    os.close(fd)
    try:
        table.save(path)
        round_trip = LatencyTable.load(path).to_dict() == table.to_dict()
    finally:
        os.unlink(path)
    ops.clear_tuned_blocks()
    launches = dict(LAUNCHES)
    seconds = time.perf_counter() - t0

    def cell(e):
        return {"op": e.op, "shape": list(e.shape), "blocks": e.blocks,
                "median_s": e.median_s, "flops": e.flops,
                "tflops": e.flops / e.median_s / 1e12 if e.median_s > 0 else None}
    emit("kbench", fingerprint=fp, trials=trials, warmup=warmup,
         collected=[cell(e) for e in collected], launches_grew=grew,
         sweeps=[{"op": sw.op, "shape": list(sw.shape),
                  "best_blocks": sw.best_blocks, "best_s": sw.best_s,
                  "default_blocks": sw.default_blocks, "default_s": sw.default_s,
                  "speedup": sw.speedup,
                  "sweep": [[b, t] for b, t in sw.sweep]} for sw in sweeps],
         installed=n_installed, resolved=resolved,
         full_width=[cell(e) for e in full],
         rmsnorm_main_ms={"shape": list(RMS_MAIN), "blocks": k4_blocks,
                          "per_call": k4_per_call, "back_to_back": k4_b2b,
                          "host_share_per_call": 1 - k4_b2b / k4_per_call},
         flash_with_winners_installed=resolved_calls,
         table_cells=len(table), table_round_trip=round_trip,
         table_fingerprint=table.fingerprint(), launches=launches,
         seconds=seconds, table=table.to_dict())
    bad = [e for e in table.entries if not e.device.startswith("cuda:")
           or not e.median_s > 0]
    if bad:
        raise SystemExit(f"kbench cells not measured on the card: {bad}")
    if sorted(e.op for e in collected) != sorted(harness.OPS):
        raise SystemExit(f"kbench collected {[e.op for e in collected]}")
    if any(n < trials + warmup for n in grew.values()):
        raise SystemExit(f"launches grew by {grew}, expected at least "
                         f"{trials + warmup} each")
    if not all(c["ok"] for c in resolved_calls):
        raise SystemExit(f"ops.flash_attention with the winners installed: "
                         f"{resolved_calls}")
    want = [{"op": sw.op, "shape": list(sw.shape), "blocks": sw.best_blocks}
            for sw in sweeps if sw.best_blocks]
    if [r for r in resolved if r["blocks"]] != want or n_installed != len(want):
        raise SystemExit(f"installed winners {want} resolve to {resolved}")
    main_shape = tuple(KBENCH_FULL["flash_attention"])
    d80 = next(c for c in resolved_calls if tuple(c["shape"]) == main_shape)
    if tuple(d80["launched_blocks"]) != tuple(sw80.best_blocks):
        raise SystemExit(f"gpt-2b's D = 80 shape launched {d80['launched_blocks']}, "
                         f"not the tile swept there {sw80.best_blocks}")
    if tuned_call_launched != 1:
        raise SystemExit("ops.rmsnorm with the winner installed did not launch K4")
    if not round_trip:
        raise SystemExit("the kbench table did not round-trip through JSON")
    return table, fp, launches


def h100_fleet():
    """An H100 mesh (one host, two cards on NVLink) in front of the paper's
    case-study A100 (2 x 2) and V100 (1 x 2) meshes, 5 Gbps across."""
    from repro_torch.core.cluster import (
        GBPS, H100_80G, HeteroCluster, SubCluster, paper_case_study_cluster,
    )
    base = paper_case_study_cluster()
    h100 = SubCluster("meshH100", 1, 2, H100_80G, 450e9, 200 * GBPS)
    return HeteroCluster(subclusters=(h100,) + base.subclusters,
                         cross_bw=base.cross_bw)


def run_plan(table, fp):
    """The HAPT planner on the host, priced three ways from the same fleet."""
    from repro_torch.configs import get_config
    from repro_torch.core.planner import HAPTPlanner, PlannerConfig
    from repro_torch.kbench.bridge import KBenchConfig, KBenchModel

    fleet = h100_fleet()
    measured = KBenchConfig(table=table.to_dict(), device_map={"H100-80G": fp})
    model = KBenchModel(measured)
    mfu = {s.name: model.measured_mfu(s) for s in fleet.subclusters}
    for arch in ("gpt-2b", "mamba2-2.7b"):
        plans = {}
        for kind, kb in (("off", None), ("empty", KBenchConfig()),
                         ("table", measured)):
            t0 = time.perf_counter()
            strategy = HAPTPlanner(fleet, PlannerConfig(kbench=kb)).plan(
                get_config(arch), seq_len=1024, global_batch=64)
            plan_s = time.perf_counter() - t0
            d = json.loads(strategy.to_json())
            d["planner_meta"] = {k: v for k, v in d["planner_meta"].items()
                                 if not k.startswith("time_")}
            plans[kind] = d
            emit("plan", arch=arch, kbench=kind, seq_len=1024, global_batch=64,
                 est_step_time=strategy.est_step_time, plan_s=plan_s,
                 stages=[{"subcluster": fleet.subclusters[st.cluster_idx].name,
                          "layers": st.layer_end - st.layer_start,
                          "mesh": [st.mesh_n, st.mesh_m], "tp": st.tp,
                          "dp": st.dp, "t_f": st.t_f, "t_b": st.t_b}
                         for st in strategy.stages],
                 measured_mfu=mfu if kind == "table" else None,
                 kbench_stamp=d["planner_meta"].get("kbench"))
        empty = dict(plans["empty"], planner_meta={
            k: v for k, v in plans["empty"]["planner_meta"].items() if k != "kbench"})
        if empty != plans["off"]:
            raise SystemExit(f"{arch}: an empty kbench table priced unlike kbench=None")
        stamp = plans["table"]["planner_meta"]["kbench"]
        if fp not in stamp["covered_devices"] or mfu["meshH100"] is None:
            raise SystemExit(f"{arch}: the card's table does not cover H100-80G: "
                             f"{stamp}")


def run_timing_rmsnorm(gen):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rmsnorm_ref

    rows = {}
    for shape in RMS_WIDE:
        x, w = rms_inputs(shape, "float32", gen)
        plain_a = cuda_ms(lambda: rmsnorm_ref(x, w), warmup=1, iters=5)
        kernel_ms = cuda_ms(lambda: ops.rmsnorm(x, w))
        library_ms = cuda_ms(lambda: F.rms_norm(x, (shape[-1],), w, 1e-6))
        plain_b = cuda_ms(lambda: rmsnorm_ref(x, w), warmup=1, iters=5)
        bound_ms, bound_by = rms_bound(shape)
        row = dict(case=list(shape), ms=kernel_ms, plain_ms=(plain_a + plain_b) / 2,
                   library_ms=library_ms, library_call="F.rms_norm",
                   bound_ms=bound_ms, bound_by=bound_by)
        rows[shape] = row
        emit("timing", kernel="rmsnorm", dtype="float32", **row,
             plain_ms_first=plain_a, plain_ms_last=plain_b,
             share_of_bound=bound_ms / kernel_ms)
        del x, w
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import set_float32_precision
    from repro_torch.kernels import build

    set_float32_precision()                      # no TF32 anywhere
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)),
         disk_free_gb=shutil.disk_usage(ROOT).free / 1e9)

    t0 = time.perf_counter()
    logs = build.build_all()
    fwd_res = kernel_resources("flash_attention_fwd.cu")
    bwd_res = kernel_resources("flash_attention_bwd.cu")
    ssd_res = kernel_resources("ssd_intra.cu")
    emit("build", seconds=time.perf_counter() - t0, sources=list(build.SOURCES),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln],
         fwd_kernels=fwd_res, bwd_kernels=bwd_res, ssd_kernels=ssd_res)
    check_flash_build({**fwd_res, **bwd_res})
    check_ssd_build(ssd_res)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fwd_err, (fwd_share, fwd_share_case) = check_kernel_cases(gen)
    bwd_err = check_bwd_kernel_cases(gen)
    ssd_err = check_ssd_cases(gen)
    rms_err = check_rmsnorm_cases(gen)
    serve_launches = run_main_path()
    run_contract()
    train_launches, _ = run_train()
    run_train_contract()
    free_memory()                                # nothing of gpt-2b stays
    ssm_serve_launches = run_main_ssm()
    run_contract_ssm()
    ssm_train_launches, _ = run_train_ssm()
    run_train_contract_ssm()
    free_memory()
    table, fp, kbench_launches = run_kbench()
    run_plan(table, fp)
    rows = run_timing(gen)
    ssd_rows = run_timing_ssd(gen)
    rms_rows = run_timing_rmsnorm(gen)

    def entry(kernel, source, replaces, launches, err, case, **extra):
        r = rows[(kernel, case, "float32")]
        return {"name": kernel, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "shape": list(case),
                "dtype": "float32", **extra}

    bwd_src = "src/repro_torch/csrc/flash_attention_bwd.cu"
    print(json.dumps({"kernels": [
        entry("flash_attention_fwd", "src/repro_torch/csrc/flash_attention_fwd.cu",
              "src/repro/kernels/ops.py:120", serve_launches["flash_attention_fwd"],
              fwd_err, GPT2B_PREFILL, tol=TOL["float32"],
              launches_train=train_launches["flash_attention_fwd"],
              train_ms=rows[("flash_attention_fwd", GPT2B_TRAIN, "float32")]["ms"],
              train_bound_ms=rows[("flash_attention_fwd", GPT2B_TRAIN, "float32")]["bound_ms"],
              train_library_ms=rows[("flash_attention_fwd", GPT2B_TRAIN,
                                     "float32")]["library_ms"],
              worst_f32_share_of_tol=fwd_share,
              worst_f32_share_case=list(fwd_share_case)),
        entry("flash_attention_bwd_dq", bwd_src,
              "src/repro/kernels/flash_attention.py:236",
              train_launches["flash_attention_bwd_dq"],
              bwd_err["flash_attention_bwd_dq"], GPT2B_TRAIN,
              tol=GRAD_TOL["float32"]),
        entry("flash_attention_bwd_dkv", bwd_src,
              "src/repro/kernels/flash_attention.py:258",
              train_launches["flash_attention_bwd_dkv"],
              bwd_err["flash_attention_bwd_dkv"], GPT2B_TRAIN,
              tol=GRAD_TOL["float32"]),
        {"name": "ssd_intra", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_intra.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:59",
         "launches": ssm_serve_launches["ssd_intra"],
         "max_abs_err": ssd_err[MAMBA_PREFILL],
         **{k: ssd_rows[MAMBA_PREFILL][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shape": list(MAMBA_PREFILL[:6]), "dtype": "float32",
         "tol": list(SSD_TOL),
         "bound_simt_ms": ssd_rows[MAMBA_PREFILL]["bound_simt_ms"],
         "share_of_bound": (ssd_rows[MAMBA_PREFILL]["bound_ms"]
                            / ssd_rows[MAMBA_PREFILL]["ms"]),
         "launches_train": ssm_train_launches["ssd_intra"],
         "train_shape": list(MAMBA_TRAIN[:6]),
         "train_ms": ssd_rows[MAMBA_TRAIN]["ms"],
         "train_bound_ms": ssd_rows[MAMBA_TRAIN]["bound_ms"],
         "train_bound_simt_ms": ssd_rows[MAMBA_TRAIN]["bound_simt_ms"],
         "train_plain_ms": ssd_rows[MAMBA_TRAIN]["plain_ms"],
         "train_max_abs_err": ssd_err[MAMBA_TRAIN]},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:32",
         "launches": kbench_launches["rmsnorm"],
         "max_abs_err": rms_err[RMS_MAIN],
         **{k: rms_rows[RMS_MAIN][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shape": list(RMS_MAIN), "dtype": "float32", "tol": list(RMS_WIDE_TOL),
         "launches_path": "kbench (collect, autotune, full-width bench_op)",
         "launches_main": {"main": serve_launches["rmsnorm"],
                           "train": train_launches["rmsnorm"],
                           "main_ssm": ssm_serve_launches["rmsnorm"],
                           "train_ssm": ssm_train_launches["rmsnorm"]},
         "wide_shape": list(RMS_WIDE[1]),
         "wide_ms": rms_rows[RMS_WIDE[1]]["ms"],
         "wide_bound_ms": rms_rows[RMS_WIDE[1]]["bound_ms"],
         "wide_plain_ms": rms_rows[RMS_WIDE[1]]["plain_ms"],
         "wide_library_ms": rms_rows[RMS_WIDE[1]]["library_ms"],
         "wide_max_abs_err": rms_err[RMS_WIDE[1]]},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
