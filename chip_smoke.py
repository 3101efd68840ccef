#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX or of the JAX package.  Phases, one JSON line
each (``{"phase": ...}``):

  device    card name, count and ``nvidia-smi`` name / power limit;
  build     compiles every CUDA source of the port with nvcc (seconds);
  kernel    each kernel against its plain PyTorch version on the card, on
            the reference's flash cases plus the shapes of the serving and
            the training path: the forward in float32 (tolerance 2e-5) and
            bfloat16 (2e-2), out and lse; the backward's dq kernel (dq) and
            dk/dv kernel (dk, dv) in float32 (atol 5e-5, rtol 1e-3) and
            bfloat16 (atol 4e-3, rtol 8e-3);
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
  timing    each kernel at its main path's shape (the forward at the prefill
            and the training shape, the backward kernels at the training
            shape) against its plain version, a PyTorch call that computes
            the same (``F.scaled_dot_product_attention`` and its backward,
            timed only as a yardstick, never called by the port) and the
            card's bound.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
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
    dk/dv:   reads q, k, v, do, lse, delta, writes dk, dv; 4 (S, dP, dV, dK)."""
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
                ok = all(torch.allclose(a.float(), b.float(), atol=atol, rtol=rtol)
                         for a, b in pairs.values())
                emit("kernel", kernel=kernel, case=case, dtype=dtype,
                     **{f"max_abs_err_{n}": e for n, e in err.items()},
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
            "flash_attention_bwd_dkv": cfg.n_layers * TRAIN_STEPS}
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
            bound_ms, bound_by = flash_bound(case, dtype, kernel)
            row = dict(case=case, ms=kernel_ms, plain_ms=(plain_a + plain_b) / 2,
                       library_ms=library_ms, library_call=library_call,
                       bound_ms=bound_ms, bound_by=bound_by)
            rows[(kernel, case, dtype)] = row
            emit("timing", kernel=kernel, dtype=dtype, **row,
                 plain_ms_first=plain_a, plain_ms_last=plain_b,
                 share_of_bound=bound_ms / kernel_ms)
        del timed, q, k, v, qt, kt, vt
        free_memory()
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
    emit("build", seconds=time.perf_counter() - t0, sources=list(build.SOURCES),
         ptxas=[ln.strip() for log in logs.values() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    fwd_err = check_kernel_cases(gen)
    bwd_err = check_bwd_kernel_cases(gen)
    serve_launches = run_main_path()
    run_contract()
    train_launches, _ = run_train()
    run_train_contract()
    rows = run_timing(gen)

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
              launches_train=train_launches["flash_attention_fwd"]),
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
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
