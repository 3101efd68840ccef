#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX or of the JAX package.  Phases, one JSON line
each (``{"phase": ...}``):

  device    card name, count and ``nvidia-smi`` name / power limit;
  build     compiles every CUDA source of the port with nvcc (seconds);
  kernel    each kernel against its plain PyTorch version on the card, on
            the reference's flash cases plus the serving path's shapes, in
            float32 (tolerance 2e-5) and bfloat16 (2e-2), out and lse;
  main      ``repro_torch.api.generate("gpt-2b", batch=8, prompt_len=512,
            gen_tokens=32)`` at full width with launch counts reset just
            before and read just after (32 flash launches: one per layer);
  contract  at full width, prefill then stepwise decode (float32 cache)
            against the full forward's logits, and the forward with the
            kernel against the forward with plain attention;
  timing    the flash kernel at the gpt-2b prefill shape against its plain
            version, ``F.scaled_dot_product_attention`` (timed only as a
            yardstick, never called by the port) and the card's bound.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
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
EXTRA_CASES = [
    GPT2B_PREFILL,                         # the main path's shape
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


def flash_bound(case, dtype: str):
    """Least time for the work: each input read once, each output written
    once, 4*D operations per visible pair at the dtype's peak."""
    B, T, S, H, KV, D, causal, window = case
    elem = 4 if dtype == "float32" else 2
    nbytes = elem * D * (2 * B * T * H + 2 * B * S * KV) + 4 * B * H * T
    ops = 4 * D * B * H * visible_pairs(T, S, causal, window)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def qkv(case, dtype, gen):
    B, T, S, H, KV, D = case[:6]
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    return rnd(B, T, H, D), rnd(B, S, KV, D), rnd(B, S, KV, D)


def check_kernel_cases(gen):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_ref

    failures, main_err = [], None
    for case in FLASH_CASES + EXTRA_CASES:
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
            emit("kernel", kernel="flash_attention_fwd", case=case, dtype=dtype,
                 max_abs_err_out=err_out, max_abs_err_lse=err_lse,
                 neg_inf_rows_match=same_inf, tol=tol, ok=ok)
            if not ok:
                failures.append((case, dtype))
            if case == GPT2B_PREFILL and dtype == "float32":
                main_err = max(err_out, err_lse)
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return main_err


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
    if launches["flash_attention_fwd"] != cfg.n_layers:
        raise SystemExit(f"expected {cfg.n_layers} flash launches in prefill, "
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


def run_timing(gen):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_ref

    rows = {}
    for dtype in ("float32", "bfloat16"):
        case = GPT2B_PREFILL
        causal, window = case[6], case[7]
        q, k, v = qkv(case, dtype, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        # plain before and after the kernel, so drift shows
        plain_a = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal,
                                                      window=window), iters=5)
        kernel_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal,
                                                        window=window))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        plain_b = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal,
                                                      window=window), iters=5)
        bound_ms, bound_by = flash_bound(case, dtype)
        rows[dtype] = dict(case=case, ms=kernel_ms, plain_ms=(plain_a + plain_b) / 2,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        emit("timing", kernel="flash_attention_fwd", dtype=dtype, **rows[dtype],
             plain_ms_first=plain_a, plain_ms_last=plain_b,
             share_of_bound=bound_ms / kernel_ms)
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
         capability=list(torch.cuda.get_device_capability(0)))

    t0 = time.perf_counter()
    logs = build.build_all()
    emit("build", seconds=time.perf_counter() - t0, sources=list(build.SOURCES),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main_err = check_kernel_cases(gen)
    launches = run_main_path()
    run_contract()
    rows = run_timing(gen)

    f32 = rows["float32"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/ops.py:120",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": main_err, "tol": TOL["float32"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "shape": list(GPT2B_PREFILL), "dtype": "float32",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
