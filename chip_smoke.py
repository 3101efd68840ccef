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
            forward is on the ``kernels`` line); the shapes include
            zamba2-7b's prefill and training, (8, 512 or 1024, same, 32, 32,
            112), where the wide kernels (D > 80) run; whisper-medium's
            encoder (8, 1500, 1500, 16, 16, 64, non-causal, a ragged last
            tile), cross attention (8, 448, 1500, ...) and decoder (8, 448,
            448, ..., causal), the backward too; the VLM's self (8, 512, 512,
            64, 8, 128, causal) and cross attention (8, 512, 1601, ...,
            non-causal), the forward only; the pipeline's microbatch (2,
            1024, 1024, 32, 32, 80, causal), forward and backward;
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
            bit-equal (the host tree is kept for the ``mesh`` phase and the
            file deleted);
  train_contract  at full width, batch 1 x 256: every gradient of ``loss``
            with the kernels against the same with plain attention;
  kernel    also the SSD intra-chunk kernel (``ssd_intra``, K5) against its
            plain version in float32 (atol 1e-4, rtol 1e-3) on the
            reference's property cases, Q = 100, mamba2-2.7b's prefill and
            training shapes (the prefill one in the model's strided layout),
            zamba2's N = 64 (also at zamba2-7b's prefill, strided, and
            training shapes, 112 heads x 64), a ragged P > 64, a chunk whose dt span is
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
  main_moe  ``generate("granite-moe-1b-a400m", batch=8, prompt_len=512,
            gen_tokens=32)`` at full width (24 flash launches: one per layer
            in prefill, at D = 64, GQA 16 / 8; decode attention is plain);
  contract_moe  at full width, batch 2 x 40, prefill 32, at capacity factor
            n_experts / top_k (4: C >= the tokens of every call, so nothing
            drops): prefill then stepwise decode (float32 cache) against the
            full forward, and the kernels against plain attention in the
            form that routing near-ties cannot fail at random: (a) each
            layer's attention sub-block with K1 against plain attention from
            the same input, at 2e-5; (b) the token-layers whose expert set
            differs between the two paths, each path run on its own and, per
            layer, from the same input, with the plain side's top-k margin
            (k-th minus (k+1)-th router probability); (c) the whole-model
            logits gated at 2e-3 when no route differs; when some do, every
            route that differs from the same input, and every one of the
            first layer where the two runs part, must be a near-tie (margin
            under 1e-5), and the logits are recorded, not gated; and the
            MoE block's forward and backward at the training shape under
            ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
  train_moe ``fit("granite-moe-1b-a400m", HarpConfig(seq_len=1024,
            global_batch=8, ...))`` for 3 steps at full width, no checkpoint
            (per step 48 forward launches, the remat recompute included,
            and 24 of each backward kernel); finite losses, an aux loss
            above 0, step 1's loss against the plain path's, with (b) / (c)
            on step 1's batch;
  train_contract_moe  at full width, batch 1 x 256, the published capacity
            factor: (a) each layer's attention sub-block VJP (K2 / K3) from
            the same input and cotangent against plain attention's (the h
            gradient at atol 5e-5, rtol 1e-3; wq, wk, wv, wo, sums over the
            tokens, per layer by relative norm at 1e-4); every gradient of ``loss`` with the kernels
            against plain attention's, (b) / (c) as above; the ``wq``,
            ``wk``, ``wv``, ``router``, ``w_up``, ``w_gate`` and ``w_down``
            gradients finite and non-zero;
  main_hybrid  ``generate("zamba2-7b", batch=8, prompt_len=512,
            gen_tokens=32)`` at full width and depth (81 SSD layers, the
            shared attention block applied after every 6: 13 flash launches
            at D = 112, 32 heads MHA, and 81 ``ssd_intra`` launches at 112
            heads x 64, N = 64, in prefill; decode attention and the SSD
            recurrence are plain);
  contract_hybrid  at full width and depth, batch 2 x 40, prefill 32:
            prefill then stepwise decode (float32 cache) against the full
            forward, the forward with the kernels against the plain forward
            (2e-3), and each of the 13 applications' attention sub-block
            with K1 against plain attention from the same input (2e-5);
  train_hybrid  ``fit`` of zamba2-7b at 27 layers (4 groups of 6 SSD layers
            and the shared application, then the 3-layer tail; 81 layers
            need 113 GB of params, gradients and AdamW moments),
            ``HarpConfig(seq_len=1024, global_batch=8, ...)``, 3 steps at
            full width, no checkpoint: per step 8 flash forward launches (4
            applications, twice with the group remat), 4 of each backward
            kernel and 54 ``ssd_intra``; finite losses and gradient norms,
            step 1's loss against the plain path's;
  train_contract_hybrid  at full width and 27 layers, batch 1 x 512: every
            gradient of ``loss`` with the kernels against the plain versions
            (1e-4 relative), every gradient finite, the shared block's, the
            adapters' and the SSD projections' non-zero;
  main_audio  ``generate("whisper-medium", batch=8, prompt_len=416,
            gen_tokens=32)`` at full width and depth (24 encoder layers over
            1500 frames, 24 decoder layers; 448 decoder positions, Whisper's
            published context): 72 flash launches in prefill (24 non-causal
            encoder, 24 causal decoder, 24 cross over the 1500 memory rows),
            D = 64, 16 heads MHA; decode attention, self and cross, is plain;
  contract_audio  at full width and depth, batch 2 x 40, prefill 32, over
            unit-scale frames: prefill then stepwise decode (float32 cache)
            against the full forward, and the forward with the kernels
            against the plain forward (2e-3);
  train_audio  whisper-medium's training at full width and depth, 8 x 448
            tokens over 1500 frames per row, 3 steps, through
            ``make_train_step`` under ``fit(train_step=..., state=...)``
            (fit's pipeline makes no frames), no checkpoint: per step 144
            flash forward launches (per-layer remat) and 72 of each backward
            kernel; finite losses, step 1's loss against the plain path's;
  train_contract_audio  at full width and depth, batch 1 x 448: every
            gradient of ``loss`` with the kernels against plain attention
            (1e-4 relative), every gradient finite, the encoder's (reached
            only through the decoder's cross attention) non-zero;
  main_vlm  ``generate`` of llama-3.2-vision-90b at full width and 10 of
            its 100 layers (2 groups of 4 self blocks and a gated cross
            block over 1601 image tokens; 10.66 B parameters, 42.6 GB: full
            depth fits no card, and it does not train on one), batch 8,
            prompt 512, 32 new tokens: 10 flash launches in prefill at D =
            128, GQA 8;
  contract_vlm  as contract_audio at 10 layers over unit-scale image
            embeddings, with the cross blocks' gates at 0.5 (0 at init,
            where they add nothing); closing them must move the logits by
            more than the tolerance;
  pipeline  HARP's inter-operator pipeline on full-width gpt-2b:
            ``make_pipeline_train_step("gpt-2b", n_stages=2,
            n_microbatches=4)`` (2 stages of 16 layers), batch 8 x 1024
            (microbatches of 2 x 1024), bf16 activations, the local transport
            (both stages on the card), 3 steps, launch counts reset just
            before and read after every step: per step 320 flash forward
            launches (2 stages x 5 slots x 16 layers, and the slot remat's
            recompute) and 160 of each backward kernel, at (2, 1024, 1024,
            32, 32, 80) causal bf16; finite losses, step 1's loss against the
            single-pod ``model.loss`` on the same params and batch (bf16
            activations 2e-3, f32 2e-3; near log(vocab) at init, so blind
            to misrouting, which the contract's gradients catch); step
            seconds, tokens/s, peak memory;
  pipeline_contract  at full width, batch 2 x 256 in 2 microbatches, f32,
            the embedding table rounded to bf16 (which the pipeline's input
            round trip then leaves exact): the pipeline's loss (1e-5) and
            every gradient, unstaged, against the single-pod
            ``value_and_grad(model.loss)`` with the kernels (1e-4 relative
            per leaf; the embedding's, which comes back through the bf16
            input, 2**-7), and against the same pipeline on the plain path;
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
  compile   HARP's own entry point at full width: ``api.plan("gpt-2b",
            h100_fleet(), HarpConfig(seq_len=1024, global_batch=8, kbench=<the
            card's table>, obs=ObsConfig(run_log=...)))``, the Plan written
            as JSON and read back into ``api.compile`` (bit-identical),
            ``attach_elastic()`` and ``fit`` for 3 steps on the card, launch
            counts reset just before and read just after; the losses equal
            the ``train`` phase's (relative 1e-4), the launches too (K4 and
            K5 0), 3 ``step`` lines in the run log, the drift ledger fed every
            step after the controller's warm-up, the controller's first
            decision "seeded from compiled plan"; the plan's est_step_time
            and split, the measured steps, peak memory, the drift report and
            the controller's decisions on the line.  The plan prices the
            fleet's meshes; ``fit`` trains the whole model on the card, so
            the drift is a record, not a cost-model error;
  cli       ``repro_torch.api.cli.main`` in process, counts reset just
            before: ``kbench show`` of the card's table, ``plan`` of gpt-2b on
            the H100 fleet from that table (the same strategy as the planner
            priced from the table in memory at the same settings), ``kbench
            collect --ops rmsnorm`` on the card (K4's launches grow), and
            ``train --plan <mamba2-2.7b plan> --smoke --steps 2`` on the card
            (K5 launches); then the deprecated launchers in fresh
            interpreters, ``python -m repro_torch.launch.train --arch gpt-2b
            --smoke --steps 2`` and ``python -m repro_torch.launch.serve
            --arch gpt-2b --smoke``, each exiting 0 with its deprecation
            warning and its result line;
  mesh      HARP's device meshes: a one-rank NCCL process group on
            ``cuda:0`` (an in-process ``HashStore``, no network), ``api.compile``
            of gpt-2b on one H100 (1 node x 1 card) and
            ``Executable.stage_mesh(0)``: a 1 x 1 ``("data", "model")``
            ``DeviceMesh`` on cuda; ``stage_mesh`` of the H100 stage of the
            H100 fleet's plan (1 x 2) raises ``ValueError`` for want of a
            second rank.  The ``train`` phase's step-3 checkpoint of
            full-width gpt-2b, as that phase restored it on the host (read
            from disk once, held there until now), placed by ``ckpt.reshard`` onto ``train_shardings`` (params and
            AdamW moments as DTensors: reshard seconds, placements by
            kind, bytes on the card, each local shape against
            ``shard_shape``), then ``fit`` resumed for step 4 on the DTensors'
            local tensors (detached, the same storage); then the same step
            from the restored tree placed with ``torch.device("cuda")``
            leaves.  Gates: the two step-4 losses and grad norms bit-equal,
            finite, exactly 64 K1 / 32 K2 / 32 K3 / 0 K4 / 0 K5 launches in
            each resumed step (counts reset just before each), and
            ``compress_tree`` of the embedding and layer 0's slices, two
            error-feedback steps, bit-equal on the card and on the CPU with
            the wire bytes ``comm.selector.compressed_wire_bytes`` prices.
            The group is destroyed at the end of the phase;
  sharded   (in the ``mesh`` phase's group, before it is destroyed) one
            ``make_train_step(act_rules=train_act_rules(),
            use_kernels=False)`` step of full-width gpt-2b at 8 x 1024, f32,
            computing on DTensors: the same step-3 host tree placed by
            ``ckpt.reshard`` onto ``train_shardings`` of the 1 x 1 mesh, the
            batch ``Shard(0)`` over ``data``; then the same step on plain
            CUDA tensors from the same tree and batch.  Gates: loss and grad
            norm bit-equal or within 1e-6 relative, every leaf a DTensor
            whose local shape is its ``shard_shape``, 0 launches of K1-K5
            (the reference's sharded path runs its jnp path); step seconds,
            peak memory and the ``nvidia-smi`` line in its line;
  pipeline_sharded  (in the same group, after ``sharded``) one step of
            ``make_pipeline_train_step(mesh=...)`` of full-width gpt-2b on
            a (1, 1, 1) ``("pod", "data", "model")`` cuda mesh: one stage on
            DTensors over its ``(data, model)`` sub-mesh, 4 f32 microbatches
            of 2 x 1024, ``use_kernels=False``, the staging and the AdamW
            state cut from the same step-3 host tree by ``place_stage``;
            then the local transport's step (S = 1) on plain CUDA tensors
            from the same tree and batch.  Gates: loss and grad norm
            bit-equal or within 1e-6 relative, the params, ``mu`` and ``nu``
            the two updates leave within 1e-5 of each other per leaf
            (relative to the update), every leaf a DTensor on the sub-mesh
            whose local shape is its ``shard_shape``, 0 launches of K1-K5.
            One stage has no shift: the NCCL send and receive between
            stages are not exercised on one card (the line says so);
  dryrun    the launcher's dry run (``launch.dryrun.run_cell``) at full
            published size in a fake process group of 256 ranks (512 for
            ``multi``) on the host, nothing on the card: a dense train cell
            (gemma-2b, one microbatch scaled by 16, ``REPRO_FAST_ANALYSIS``),
            a dense prefill (gemma-2b) and decode (deepseek-7b), mamba2's
            and zamba2's ``long_500k``, a MoE train cell (granite-moe, one
            microbatch scaled by 16) and decode, and a multi-pod decode
            (minitron-8b); one line each (ok, trace seconds, peak and
            argument bytes per device, FLOPs, collectives by kind and mesh
            dim), marked as host counts.  Gates: every cell ``ok``, its
            argument bytes the sum of its leaves' ``shard_shape`` bytes;
  timing    each kernel at its main path's shape (the flash forward at the
            prefill and the training shape, the backward kernels at the
            training shape, of gpt-2b and, f32, of granite-moe, zamba2-7b and
            whisper-medium, the forward at the VLM's two shapes, all
            three at the pipeline's microbatch in bf16,
            K5 at mamba2's and zamba2-7b's prefill and training shapes, K4
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

Then a ``total`` line (the script's seconds so far, the build included),
the ``kernels`` line (K4's launches are the ``kbench`` phase's; the
model phases assert 0; ``launches_compile`` and ``launches_cli`` are the
two control-plane phases', ``launches_moe`` and ``launches_train_moe``
granite-moe's, with the flash kernels' numbers at its shapes under
``granite_prefill`` / ``granite_train``; ``launches_hybrid`` and
``launches_train_hybrid`` zamba2-7b's, with K1-K3's and K5's numbers at its
shapes under ``zamba_prefill`` / ``zamba_train``; ``launches_audio``,
``launches_train_audio`` and ``launches_vlm`` the audio and VLM phases',
with K1's numbers under ``whisper_enc`` / ``whisper_cross`` /
``whisper_dec`` / ``vlm_self`` / ``vlm_cross`` and K2's and K3's under the
three whisper ones; ``launches_mesh`` the ``mesh`` phase's first resumed
step; ``launches_pipeline`` the ``pipeline`` phase's, with
K1-K3's bf16 numbers at its microbatch under ``pipeline``), the
``nvidia-smi`` line,
and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line; without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
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
# zamba2-7b's K5 shapes: 112 SSM heads x 64, N = 64, chunk 256
ZAMBA_SSD_PREFILL = (8, 2, 256, 112, 64, 64, "A=-1")
ZAMBA_SSD_TRAIN = (8, 4, 256, 112, 64, 64, "A=-1")
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
    ZAMBA_SSD_PREFILL,
    ZAMBA_SSD_TRAIN,
]
# K5 cases handed over in the model's strided layout (views of one xBC)
SSD_STRIDED = (MAMBA_PREFILL, ZAMBA_SSD_PREFILL)
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
# granite-moe-1b-a400m: 16 query heads on 8 KV heads at D = 64
GRANITE_PREFILL = (8, 512, 512, 16, 8, 64, True, 0)
GRANITE_TRAIN = (8, 1024, 1024, 16, 8, 64, True, 0)
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SERVE = dict(batch=8, prompt_len=512, gen_tokens=32)
MOE_TRAIN_BT = (8, 1024)
# a routing near-tie: the k-th and (k+1)-th router probabilities of a token
# closer than this.  The kernel and plain attention differ by ~1e-7
# relative, which moves a probability of ~0.04 by ~1e-8, so only such a tie
# can flip a route between the two paths
MOE_TIE = 1e-5
# zamba2-7b: 81 SSD layers and one shared attention block (32 heads x 112,
# MHA) applied after every 6 of them (13 applications, a 3-layer tail).
# Serving runs at full depth.  Training at full depth needs 16 B x 7.08 B
# params = 113 GB of params, gradients and AdamW moments, over the card's
# 80 GB, so fit runs at 27 layers (4 groups of 6 and the same 3-layer tail)
# at full width and batch
HYBRID_ARCH = "zamba2-7b"
HYBRID_SERVE = dict(batch=8, prompt_len=512, gen_tokens=32)
HYBRID_TRAIN_BT = (8, 1024)
HYBRID_TRAIN_LAYERS = 27
ZAMBA_PREFILL = (8, 512, 512, 32, 32, 112, True, 0)
ZAMBA_TRAIN = (8, 1024, 1024, 32, 32, 112, True, 0)
# whisper-medium: 24 encoder layers over 1500 frames (non-causal) and 24
# decoder layers (causal self attention, then cross attention over the
# encoder's output), 16 heads x 64, MHA, at full width and depth.  Serving
# runs a 416-token prompt and 32 new tokens, 448 decoder positions:
# Whisper's published decoder context (n_text_ctx = 448, arXiv:2212.04356);
# training 8 x 448 tokens, 1500 frames per row
AUDIO_ARCH = "whisper-medium"
AUDIO_SERVE = dict(batch=8, prompt_len=416, gen_tokens=32)
AUDIO_TRAIN_BT = (8, 448)
WHISPER_ENC = (8, 1500, 1500, 16, 16, 64, False, 0)
WHISPER_CROSS = (8, 448, 1500, 16, 16, 64, False, 0)
WHISPER_DEC = (8, 448, 448, 16, 16, 64, True, 0)
WHISPER_CASES = (WHISPER_ENC, WHISPER_CROSS, WHISPER_DEC)
# llama-3.2-vision-90b at full width (d 8192, 64 heads x 128 on 8 KV heads,
# swiglu d_ff 28672, vocab 128256, 1601 image tokens), depth cut 100 -> 10
# layers (2 groups of 4 self blocks and 1 cross block): each block is 855.6 M
# parameters, embed and lm_head 2.10 B, so 10 layers are 10.66 B, 42.6 GB in
# f32; full depth (87.7 B, 351 GB) fits no card.  It serves only: training
# even 5 layers needs 16 B x 6.38 B = 102 GB of params, gradients and AdamW
# moments
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 10
VLM_SERVE = dict(batch=8, prompt_len=512, gen_tokens=32)
VLM_SELF = (8, 512, 512, 64, 8, 128, True, 0)
VLM_CROSS = (8, 512, 1601, 64, 8, 128, False, 0)
VLM_CASES = (VLM_SELF, VLM_CROSS)
# the VLM's tanh gates start at 0, where its cross blocks add nothing and a
# contract cannot see them: its contract runs with them at this value
VLM_GATE = 0.5
# HARP's pipeline on full-width gpt-2b: 2 stages of 16 layers, 4 microbatches
# of 2 x 1024 tokens, bf16 activations (the reference's default act dtype)
PIPE_STAGES, PIPE_MB, PIPE_BT = 2, 4, (8, 1024)
PIPE_TRAIN = (2, 1024, 1024, 32, 32, 80, True, 0)   # K1-K3 per microbatch
# step 1 of the pipeline against the single-pod loss on the same params and
# batch: with the activations in bf16 as the stages run them (the same
# operations on other GEMM shapes: a microbatch of 2 rows against 8), and in
# f32 (bf16 rounding through 32 layers; 2.07e-4 on an H100).  At init the
# loss is near log(vocab) for any routing, so these gates cannot see a
# microbatch or its labels misrouted: pipeline_contract's per-leaf
# gradients guard the routing
PIPE_STEP1_TOL = 2e-3
PIPE_STEP1_F32_TOL = 2e-3
# the f32 contract (2 x 256, 2 microbatches): loss and each gradient leaf by
# relative norm, pipeline against single pod and kernels against plain, as
# TRAIN_CONTRACT_TOL; the embedding's gradient comes back through the
# pipeline's bf16 input: 2**-7 of its norm
PIPE_LOSS_TOL = 1e-5
PIPE_CONTRACT_TOL = 1e-4
PIPE_EMBED_TOL = 2 ** -7
# the kernels line's names of this slice's flash shapes
NEW_SHAPES = {"whisper_enc": WHISPER_ENC, "whisper_cross": WHISPER_CROSS,
              "whisper_dec": WHISPER_DEC, "vlm_self": VLM_SELF,
              "vlm_cross": VLM_CROSS}
# the flash shapes whose backward kernels are timed
TRAIN_CASES = (GPT2B_TRAIN, GRANITE_TRAIN, ZAMBA_TRAIN) + WHISPER_CASES + (
    PIPE_TRAIN,)
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

    failures, errs, worst = [], {}, (0.0, None)
    for case in FLASH_CASES + EXTRA_CASES + [
            GPT2B_TRAIN, GRANITE_PREFILL, GRANITE_TRAIN, ZAMBA_PREFILL,
            ZAMBA_TRAIN, *WHISPER_CASES, *VLM_CASES, PIPE_TRAIN]:
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
            errs[case if dtype == "float32" else (case, dtype)] = max(err_out, err_lse)
            if dtype == "float32" and share > worst[0]:
                worst = (share, case)
            del q, k, v, out, lse, ro, rl
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: {failures}")
    return errs, worst


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
    for case in FLASH_CASES + EXTRA_CASES + [GPT2B_TRAIN, GRANITE_TRAIN,
                                             ZAMBA_TRAIN, *WHISPER_CASES,
                                             PIPE_TRAIN]:
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
                errs[(kernel, case) if dtype == "float32"
                     else (kernel, case, dtype)] = max(err.values())
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


def run_train(ckpt_dir):
    """The training main path at full width, through ``api.fit``.  Returns
    (launches, summary, restored): ``restored`` is the step-3 checkpoint as
    ``ckpt.restore`` gave it (step, host tree), which the ``mesh`` phase
    places and resumes from."""
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
    del restored, res, live
    free_memory()

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
    return launches, {"tokens_per_s": tok_s, "peak_mem_gb": peak_gb,
                      "losses": [h["loss"] for h in hist],
                      "restore_s": restore_s}, (step_restored, tree)


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
    runs = [(c, d) for c in (GPT2B_PREFILL, GPT2B_TRAIN)
            for d in ("float32", "bfloat16")]
    runs += [(c, "float32") for c in (GRANITE_PREFILL, GRANITE_TRAIN,
                                      ZAMBA_PREFILL, ZAMBA_TRAIN,
                                      *WHISPER_CASES, *VLM_CASES)]
    runs += [(PIPE_TRAIN, "bfloat16")]
    for case, dtype in runs:
        kw = dict(causal=case[6], window=case[7])
        # SDPA takes GQA's shared KV heads as they are (enable_gqa)
        sdpa = dict(is_causal=kw["causal"], enable_gqa=case[3] != case[4])
        q, k, v = qkv(case, dtype, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        timed = {"flash_attention_fwd": (
            lambda: flash_attention_fwd(q, k, v, **kw),
            lambda: flash_attention_ref(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **sdpa),
            "F.scaled_dot_product_attention" + (" (enable_gqa)" if sdpa["enable_gqa"]
                                                else ""))}
        if case in TRAIN_CASES:
            do = qkv(case, dtype, gen)[0]
            out, lse = flash_attention_fwd(q, k, v, **kw)
            _, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
            # yardstick: SDPA's backward (dq, dk, dv together), its forward
            # outside the timed region
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            ot = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
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
        if case in TRAIN_CASES:
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
        inputs = ssd_inputs(case, gen, strided=case in SSD_STRIDED)
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
             strided=case in SSD_STRIDED, max_abs_err=err,
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
    for case in (MAMBA_PREFILL, MAMBA_TRAIN, ZAMBA_SSD_PREFILL, ZAMBA_SSD_TRAIN):
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
# The MoE family: granite-moe-1b-a400m's main paths through K1 / K2 / K3
# ---------------------------------------------------------------------------


def moe_attention(cfg, p, h, use_kernels):
    """A block's attention sub-block: the term it adds to h."""
    from repro_torch.models import attention as attn
    from repro_torch.models.common import rms_norm
    return attn.self_attention(
        p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps), n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, use_kernels=use_kernels)


def route_record(probs, ids, top_k):
    """A routing's expert sets (N, k), sorted, and top-k margins (N,): the
    k-th minus the (k+1)-th router probability of each token."""
    top = probs.topk(top_k + 1, dim=-1).values
    return ids.sort(dim=-1).values, top[:, -2] - top[:, -1]


def moe_routes(cfg, p, hm):
    """The MoE block's routing of hm (h after attention), as ``route_record``."""
    from repro_torch.models.common import rms_norm
    from repro_torch.models.moe import route
    x = rms_norm(hm, p["ln2"], cfg.norm_eps).reshape(-1, cfg.d_model)
    probs, _, ids = route(p["moe"]["router"], x, cfg.top_k)
    return route_record(probs, ids, cfg.top_k)


@contextlib.contextmanager
def recorded_routes():
    """Every routing the port's MoE block makes while open (one per layer
    per call), in call order, as ``route_record``: ``moe.route`` is wrapped
    in place, so the paths under test run unchanged."""
    from repro_torch.models import moe
    calls, real = [], moe.route

    def route(router, x, top_k):
        probs, gate_vals, ids = real(router, x, top_k)
        calls.append(route_record(probs, ids, top_k))
        return probs, gate_vals, ids
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = real


@torch.no_grad()
def moe_layer_inputs(cfg, params, tokens):
    """Each layer's input on the kernel path, the layers run one at a time
    through the port's ``moe_lm._block_apply``."""
    from repro_torch.models import moe_lm, transformer
    from repro_torch.models.common import unstack
    h = transformer.embed_tokens(cfg, params, tokens)
    inputs = []
    for p in unstack(params["blocks"], cfg.n_layers):
        inputs.append(h)
        h, _ = moe_lm._block_apply(cfg, p, h, True)
    return inputs


def decode_order(fwd, pre, steps, n_layers, B, T, t0):
    """The prefill + decode routes per layer (the prefill's rows b * t0 + t,
    t < t0, then each decode step's rows b), and the forward's routes (rows
    b * T + t) of the same tokens in that order."""
    idx = torch.cat([
        (torch.arange(B)[:, None] * T + torch.arange(t0)).reshape(-1),
        (torch.arange(T - t0)[:, None] + t0 + torch.arange(B) * T).reshape(-1)])
    idx = idx.to(fwd[0][0].device)
    served = []
    for i in range(n_layers):
        parts = [pre[i]] + [steps[s * n_layers + i] for s in range(T - t0)]
        served.append(tuple(torch.cat(x) for x in zip(*parts)))
    return served, [(sets[idx], m[idx]) for sets, m in fwd]


def route_flips(kern, plain):
    """Token-layers whose expert set differs between two lists of per-layer
    routes, with the plain side's top-k margin of each; the first layer
    where one differs and that layer's margins; the count of plain-side
    near-ties (margin under MOE_TIE), flipped or not."""
    margins = []
    for (sets_k, _), (sets_p, m_p) in zip(kern, plain):
        margins.append(m_p[(sets_k != sets_p).any(dim=-1)].tolist())
    flat = [m for layer in margins for m in layer]
    first = next((i for i, m in enumerate(margins) if m), None)
    return {"n": len(flat), "per_layer": [len(m) for m in margins],
            "first_layer": first,
            "first_layer_margins": margins[first] if first is not None else [],
            "min_margin": min(flat, default=None),
            "max_margin": max(flat, default=None),
            "near_ties": sum(int((m < MOE_TIE).sum()) for _, m in plain),
            "min_margin_any": min(m.min().item() for _, m in plain)}


def flips_explained(whole, same_input_margins):
    """(c): routes that differ are explained when every one that differs
    from the same input, and every one of the first layer where the two
    runs part (the later ones follow from it), is a near-tie."""
    return (all(m < MOE_TIE for m in same_input_margins)
            and all(m < MOE_TIE for m in whole["first_layer_margins"]))


def moe_attention_gate(cfg, params, inputs):
    """(a) and (b) from the same input: each layer's attention sub-block
    with K1 against plain attention, from the kernel path's input to that
    layer, held at the f32 forward tolerance; and the routes that differ
    between the two from that input, with the plain side's margins."""
    from repro_torch.models.common import unstack
    tol = TOL["float32"]
    worst, bad, margins = 0.0, [], []
    with torch.no_grad():
        for i, (p, h) in enumerate(zip(unstack(params["blocks"], cfg.n_layers),
                                       inputs)):
            a_k = moe_attention(cfg, p, h, True)
            a_p = moe_attention(cfg, p, h, False)
            share = ((a_k - a_p).abs() / (tol + tol * a_p.abs())).max().item()
            worst = max(worst, share)
            if not torch.allclose(a_k, a_p, atol=tol, rtol=tol):
                bad.append(i)
            (sets_k, _), (sets_p, m_p) = (moe_routes(cfg, p, h + a_k),
                                          moe_routes(cfg, p, h + a_p))
            margins += m_p[(sets_k != sets_p).any(dim=-1)].tolist()
    return {"tol": tol, "worst_share_of_tol": worst, "layers_over_tol": bad,
            "route_flips": len(margins), "route_flip_margins": margins}


def moe_attention_vjp_gate(cfg, params, inputs, gen):
    """(a) for the backward: each layer's attention sub-block VJP with
    K2 / K3 against plain attention's, from the same input and cotangent.
    The gradient of h is held element by element at the f32 gradient
    tolerance; those of wq, wk, wv and wo, each a sum over the tokens of
    an input row times a dq / dk / dv / out row, per layer by relative norm
    at TRAIN_CONTRACT_TOL, with their worst element's share of the f32
    tolerance recorded."""
    from repro_torch.models.common import unstack
    atol, rtol = GRAD_TOL["float32"]
    names = ("h", "wq", "wk", "wv", "wo")
    share = dict.fromkeys(names, 0.0)
    rel = dict.fromkeys(names[1:], 0.0)
    bad = []
    for i, (p, h) in enumerate(zip(unstack(params["blocks"], cfg.n_layers), inputs)):
        cot = torch.randn(h.shape, generator=gen, device=h.device)
        grads = []
        for use_kernels in (True, False):
            hh = h.detach().requires_grad_()
            w = {k: v.detach().requires_grad_() for k, v in p["attn"].items()}
            a = moe_attention(cfg, dict(p, attn=w), hh, use_kernels)
            grads.append(torch.autograd.grad(a, [hh] + [w[n] for n in names[1:]], cot))
        for name, g_k, g_p in zip(names, *grads):
            share[name] = max(share[name], ((g_k - g_p).abs()
                                            / (atol + rtol * g_p.abs())).max().item())
            if name == "h":
                ok = torch.allclose(g_k, g_p, atol=atol, rtol=rtol)
            else:
                rel[name] = max(rel[name], ((g_k - g_p).norm() / g_p.norm()).item())
                ok = rel[name] <= TRAIN_CONTRACT_TOL
            if not ok:
                bad.append((i, name))
    return {"atol": atol, "rtol": rtol, "worst_share_of_tol": share,
            "weights_rel_tol": TRAIN_CONTRACT_TOL, "weights_max_rel_err": rel,
            "over_tol": bad}


def moe_block_host_syncs(cfg, params, gen):
    """The MoE block, forward and backward at the training shape and
    ``cfg``'s capacity factor, under ``torch.cuda.set_sync_debug_mode(
    "error")``: an operation that makes the host wait on the card raises
    (PyTorch calls the mode a prototype that does not see every such
    operation).  Returns the error, or None."""
    from repro_torch.models.common import layer
    from repro_torch.models.moe import moe_block
    p = {k: v.detach().requires_grad_() for k, v in layer(params["blocks"], 0)["moe"].items()}
    h = torch.randn(MOE_TRAIN_BT[0], MOE_TRAIN_BT[1], cfg.d_model, generator=gen,
                    device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe_block(p, h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor,
                             activation=cfg.activation,
                             router_aux_coef=cfg.router_aux_coef)
        (out.sum() + aux).backward()
        return None
    except RuntimeError as e:
        return str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()


def run_main_moe():
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = get_config(MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = generate(MOE_ARCH, seed=0, **MOE_SERVE)
    launches = dict(LAUNCHES)
    toks = res["tokens"]
    emit("main_moe", arch=MOE_ARCH, **MOE_SERVE, launches=launches,
         tokens_shape=list(toks.shape), prefill_s=res["prefill_s"],
         decode_s=res["decode_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = {k: 0 for k in launches}
    want["flash_attention_fwd"] = cfg.n_layers
    if launches != want:
        raise SystemExit(f"expected {want} launches in {MOE_ARCH} generate, "
                         f"got {launches}")
    shape = (MOE_SERVE["batch"], MOE_SERVE["gen_tokens"])
    if toks.shape != shape or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise SystemExit(f"bad tokens: shape {toks.shape}, "
                         f"range [{toks.min()}, {toks.max()}]")
    return launches


def run_contract_moe():
    """Prefill plus stepwise decode against the full forward, and the
    kernels against plain attention through (a)-(c), at full width."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.models.prefill import prefill

    # capacity factor n_experts / top_k: C >= the tokens of every call
    # (prefill, forward, decode step), so no assignment drops and prefill +
    # decode route as the full forward does
    cfg = get_config(MOE_ARCH)
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = build_model(cfg)                       # kernels on, cuda
    gen = generator(model.device, 1)
    params = model.init(gen)
    B, T, t0 = 2, 40, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=model.device)
    with torch.no_grad(), recorded_routes() as routes_k:
        full, aux = model.forward(params, {"tokens": tokens})
    with torch.no_grad(), recorded_routes() as routes_p:
        plain = build_model(cfg, use_kernels=False).forward(
            params, {"tokens": tokens})[0]
    finite = bool(torch.isfinite(full).all())
    kernel_vs_plain = (full - plain).abs().max().item()
    whole = route_flips(routes_k, routes_p)
    same = moe_attention_gate(cfg, params, moe_layer_inputs(cfg, params, tokens))
    with recorded_routes() as routes_pre:
        last, cache = prefill(cfg, params, {"tokens": tokens[:, :t0]},
                              cache_len=T, cache_dtype=torch.float32,
                              use_kernels=True)
    errs = [(last[:, 0] - full[:, t0 - 1]).abs().max().item()]
    with recorded_routes() as routes_dec:
        for t in range(t0, T):
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
            errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    # prefill + decode route B * t0 tokens, then B per step, the forward
    # B * T: the same tokens, compared like the kernel and plain paths
    served = route_flips(*decode_order(routes_k, routes_pre, routes_dec,
                                       cfg.n_layers, B, T, t0))
    sync_error = moe_block_host_syncs(get_config(MOE_ARCH), params, gen)
    # (c): a comparison is gated when no route differs between its two sides
    gated, decode_gated = whole["n"] == 0, served["n"] == 0
    emit("contract_moe", arch=MOE_ARCH, batch=B, tokens=T, prefill_len=t0,
         capacity_factor=cfg.capacity_factor, logits_shape=list(full.shape),
         finite=finite, aux_loss=aux.item(),
         max_abs_err_decode_vs_forward=max(errs), decode_gated=decode_gated,
         route_flips_decode_vs_forward=served,
         max_abs_err_kernel_vs_plain_forward=kernel_vs_plain,
         kernel_vs_plain_gated=gated, tol=CONTRACT_TOL,
         attention_same_input=same, route_flips_whole_model=whole,
         moe_block_host_sync=sync_error,
         note=None if gated and decode_gated else "routes differ between the "
         "two sides of a comparison: its logits recorded, not gated")
    del params, full, plain, cache
    free_memory()
    if not finite or (decode_gated and max(errs) > CONTRACT_TOL):
        raise SystemExit("moe serving contract failed at full width")
    if sync_error is not None:
        raise SystemExit(f"the MoE block makes the host wait: {sync_error}")
    if same["layers_over_tol"] or not flips_explained(whole, same["route_flip_margins"]):
        raise SystemExit(f"moe attention sub-block: layers over tolerance "
                         f"{same['layers_over_tol']}; route flips not near-ties "
                         f"{same['route_flip_margins']}, {whole}")
    if not flips_explained(served, []):
        raise SystemExit(f"moe decode routes differ beyond near-ties: {served}")
    if gated and kernel_vs_plain > CONTRACT_TOL:
        raise SystemExit(f"moe kernel vs plain forward {kernel_vs_plain}")


def run_train_moe():
    """granite-moe's training main path at full width, through ``api.fit``;
    no checkpoint is written (``ckpt_every`` above the step count)."""
    from repro_torch.api import HarpConfig, fit
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device
    from repro_torch.train.trainer import TrainerConfig

    cfg = get_config(MOE_ARCH)
    (B, T), seed = MOE_TRAIN_BT, 0
    # the plain path's loss of fit's first step (fit draws its params from a
    # generator seeded by `seed` and trains on make_batch(step 0)), and both
    # paths' routes on that batch
    plain = build_model(cfg, use_kernels=False, remat=False)
    params = plain.init(generator(plain.device, seed))
    batch0 = batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, B, seed), 0),
                             plain.device)
    with torch.no_grad(), recorded_routes() as routes_p:
        plain_total0, plain_m0 = plain.loss(params, batch0)
    with torch.no_grad(), recorded_routes() as routes_k:
        build_model(cfg).forward(params, batch0)
    plain_total0, plain_aux0 = plain_total0.item(), plain_m0["aux_loss"].item()
    whole = route_flips(routes_k, routes_p)
    del params, batch0, plain_m0, routes_k, routes_p
    free_memory()
    mem_before_gb = torch.cuda.memory_allocated() / 1e9

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_moe_", dir=build_dir)
    try:
        config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=1000, log_every=1,
            ckpt_dir=ckpt_dir))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = fit(MOE_ARCH, config, seed=seed,
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
    steps = [{k: h[k] for k in ("step", "time_s", "total_loss", "loss",
                                "aux_loss", "grad_norm", "lr", "accuracy")}
             for h in hist]
    step_s = [h["time_s"] for h in hist]
    tok_s = 2 * B * T / (step_s[1] + step_s[2])
    want = {k: 0 for k in launches}
    want["flash_attention_fwd"] = 2 * cfg.n_layers * TRAIN_STEPS
    want["flash_attention_bwd_dq"] = cfg.n_layers * TRAIN_STEPS
    want["flash_attention_bwd_dkv"] = cfg.n_layers * TRAIN_STEPS
    finite = all(math.isfinite(h["total_loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    aux_ok = all(math.isfinite(h["aux_loss"]) and h["aux_loss"] > 0 for h in hist)
    step1_rel = abs(hist[0]["total_loss"] - plain_total0) / abs(plain_total0)
    gated = whole["n"] == 0
    emit("train_moe", arch=MOE_ARCH, batch=B, seq_len=T, steps=steps,
         launches=launches, launches_expected=want,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         step_s=step_s, tokens_per_s_steps_2_3=tok_s, fit_s=fit_s,
         peak_mem_gb=peak_gb,
         mem_allocated_gb={"before_fit": mem_before_gb,
                           "after_release": torch.cuda.memory_allocated() / 1e9},
         step1_total_loss=hist[0]["total_loss"], plain_total_loss_step1=plain_total0,
         step1_aux_loss=hist[0]["aux_loss"], plain_aux_loss_step1=plain_aux0,
         step1_rel_err=step1_rel, step1_tol=STEP1_TOL, step1_gated=gated,
         route_flips_step1_batch=whole, checkpoint_files=written, finite=finite,
         aux_finite_positive=aux_ok,
         note=None if gated else "routes differ between the kernel and the "
         "plain path on step 1's batch: its loss recorded, not gated")
    if len(hist) != TRAIN_STEPS or not finite or not aux_ok:
        raise SystemExit(f"moe training did not give {TRAIN_STEPS} finite steps "
                         f"with an aux loss above 0")
    if launches != want:
        raise SystemExit(f"moe training launches {launches}, expected {want}")
    if not flips_explained(whole, []):
        raise SystemExit(f"moe step 1: routes differ beyond near-ties: {whole}")
    if gated and step1_rel > STEP1_TOL:
        raise SystemExit(f"moe step 1 loss {hist[0]['total_loss']} vs the plain "
                         f"path's {plain_total0}")
    if written:
        raise SystemExit(f"moe training wrote a checkpoint: {written}")
    return launches, {"step_s": step_s, "tokens_per_s": tok_s,
                      "peak_mem_gb": peak_gb}


def run_train_contract_moe():
    """Every gradient of the loss with the kernels against plain attention,
    and each layer's attention VJP from the same input, at full width (batch
    1 x 256, the published capacity factor)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, value_and_grad

    cfg = get_config(MOE_ARCH)
    kern = build_model(cfg)                               # kernels on, remat
    plain = build_model(cfg, use_kernels=False)
    gen = generator(kern.device, 2)
    params = kern.init(gen)
    batch = batch_to_device(make_batch(DataConfig(cfg.vocab_size, 256, 1, 2), 0),
                            kern.device)
    loss_k, m_k, g_k = value_and_grad(kern.loss, params, batch)
    loss_p, m_p, g_p = value_and_grad(plain.loss, params, batch)
    with torch.no_grad(), recorded_routes() as routes_k:
        kern.forward(params, batch)
    with torch.no_grad(), recorded_routes() as routes_p:
        plain.forward(params, batch)
    whole = route_flips(routes_k, routes_p)
    inputs = moe_layer_inputs(cfg, params, batch["tokens"])
    same = moe_attention_gate(cfg, params, inputs)
    vjp = moe_attention_vjp_gate(cfg, params, inputs, gen)
    rel, bad = {}, []
    for (path, a), (_, b) in zip(_leaves(g_k), _leaves(g_p)):
        name = ".".join(path)
        rel[name] = ((a - b).norm() / b.norm()).item()
        if not bool(torch.isfinite(a).all()):
            bad.append(f"{name} not finite")
        if (path[-1] in ("wq", "wk", "wv", "router", "w_up", "w_gate", "w_down")
                and not bool(a.abs().sum() > 0)):
            bad.append(f"{name} zero")
    worst = max(rel.values())
    gated = whole["n"] == 0
    emit("train_contract_moe", arch=MOE_ARCH, batch=1, seq_len=256,
         capacity_factor=cfg.capacity_factor,
         loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
         aux_loss_kernels=m_k["aux_loss"].item(),
         aux_loss_plain=m_p["aux_loss"].item(),
         rel_grad_err=rel, max_rel_grad_err=worst, tol=TRAIN_CONTRACT_TOL,
         grads_gated=gated, bad_grads=bad, attention_same_input=same,
         attention_vjp_same_input=vjp, route_flips_whole_model=whole,
         note=None if gated else "routes differ between the kernel and the "
         "plain path: whole-model gradients recorded, not gated")
    del g_k, g_p, params, inputs
    free_memory()
    if bad or vjp["over_tol"] or same["layers_over_tol"]:
        raise SystemExit(f"moe training contract: {bad}, attention VJP over "
                         f"tolerance {vjp['over_tol']}, forward "
                         f"{same['layers_over_tol']}")
    if not flips_explained(whole, same["route_flip_margins"]):
        raise SystemExit(f"moe training contract: routes differ beyond "
                         f"near-ties: {whole}, {same['route_flip_margins']}")
    if gated and worst > TRAIN_CONTRACT_TOL:
        raise SystemExit(f"moe training contract failed: max rel err {worst}")


# ---------------------------------------------------------------------------
# The hybrid family: zamba2-7b's main paths through K1 / K2 / K3 (D = 112)
# and K5 (N = 64)
# ---------------------------------------------------------------------------


def hybrid_train_config():
    """zamba2-7b at the depth ``fit`` runs at on one card (full width)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_TRAIN_LAYERS)


def hybrid_launches(cfg, steps: int = 1, train: bool = False) -> dict:
    """K1 once per shared application and K5 once per SSD layer in a
    forward; a training step runs each forward twice (group remat) and K2 /
    K3 once per application."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import hybrid_lm
    n_apps = hybrid_lm._n_apps(cfg)
    want = dict.fromkeys(LAUNCHES, 0)
    want["flash_attention_fwd"] = (2 if train else 1) * n_apps * steps
    want["ssd_intra"] = (2 if train else 1) * cfg.n_layers * steps
    if train:
        want["flash_attention_bwd_dq"] = want["flash_attention_bwd_dkv"] = n_apps * steps
    return want


def run_main_hybrid():
    from repro_torch.api import generate
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches

    cfg = get_config(HYBRID_ARCH)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = generate(HYBRID_ARCH, seed=0, **HYBRID_SERVE)
    launches = dict(LAUNCHES)
    toks = res["tokens"]
    want = hybrid_launches(cfg)
    emit("main_hybrid", arch=HYBRID_ARCH, **HYBRID_SERVE, n_layers=cfg.n_layers,
         launches=launches, launches_expected=want,
         tokens_shape=list(toks.shape), prefill_s=res["prefill_s"],
         decode_s=res["decode_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != want:
        raise SystemExit(f"expected {want} launches in {HYBRID_ARCH} generate, "
                         f"got {launches}")
    shape = (HYBRID_SERVE["batch"], HYBRID_SERVE["gen_tokens"])
    if toks.shape != shape or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise SystemExit(f"bad tokens: shape {toks.shape}, "
                         f"range [{toks.min()}, {toks.max()}]")
    return launches


@torch.no_grad()
def hybrid_attention_gate(cfg, params, tokens):
    """Each shared application's attention sub-block with K1 against plain
    attention, from the same input (the kernel path's, the layers run one
    at a time through the port's ``_block_apply`` / ``_shared_apply``), at
    the f32 forward tolerance."""
    from repro_torch.models import attention as attn
    from repro_torch.models import hybrid_lm, mamba_lm, transformer
    from repro_torch.models.common import linear, rms_norm, unstack
    tol = TOL["float32"]
    shared = params["shared"]
    h = transformer.embed_tokens(cfg, params, tokens)
    shares, bad = [], []
    for g, pg in enumerate(unstack(params["groups"], hybrid_lm._n_apps(cfg))):
        for p in unstack(pg, cfg.shared_attn_every):
            h = mamba_lm._block_apply(cfg, p, h, True)
        xn = rms_norm(linear(h, params["adapt_in"][g]), shared["ln1"], cfg.norm_eps)
        a_k, a_p = (attn.self_attention(
            shared["attn"], xn, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, causal=True,
            use_kernels=use) for use in (True, False))
        shares.append(((a_k - a_p).abs() / (tol + tol * a_p.abs())).max().item())
        if not torch.allclose(a_k, a_p, atol=tol, rtol=tol):
            bad.append(g)
        h = hybrid_lm._shared_apply(cfg, shared, params["adapt_in"][g],
                                    params["adapt_out"][g], h, True)
    return {"tol": tol, "share_of_tol_per_application": shares,
            "applications_over_tol": bad}


def run_contract_hybrid():
    """Prefill plus stepwise decode (f32 cache) against the full forward,
    the forward with the kernels against the plain forward, and each
    application's attention sub-block from the same input, at full width
    and depth."""
    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.models.prefill import prefill

    cfg = get_config(HYBRID_ARCH)
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
    same = hybrid_attention_gate(cfg, params, tokens)
    last, cache = prefill(cfg, params, {"tokens": tokens[:, :t0]}, cache_len=T,
                          cache_dtype=torch.float32, use_kernels=True)
    errs = [(last[:, 0] - full[:, t0 - 1]).abs().max().item()]
    for t in range(t0, T):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
        errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    emit("contract_hybrid", arch=HYBRID_ARCH, batch=B, tokens=T, prefill_len=t0,
         n_layers=cfg.n_layers, logits_shape=list(full.shape), finite=finite,
         cache_shapes={".".join(p): list(v.shape) for p, v in _leaves(cache)},
         max_abs_logit=full.abs().max().item(),
         max_abs_err_decode_vs_forward=max(errs),
         max_abs_err_kernel_vs_plain_forward=kernel_vs_plain, tol=CONTRACT_TOL,
         attention_same_input=same)
    del params, full, plain, cache
    free_memory()
    if not finite or max(errs) > CONTRACT_TOL or kernel_vs_plain > CONTRACT_TOL:
        raise SystemExit("hybrid serving contract failed at full width")
    if same["applications_over_tol"]:
        raise SystemExit(f"hybrid attention sub-block over tolerance in "
                         f"applications {same['applications_over_tol']}")


def run_train_hybrid():
    """zamba2-7b's training main path at full width and 27 layers, through
    ``api.fit``; no checkpoint is written (``ckpt_every`` above the step
    count)."""
    from repro_torch.api import HarpConfig, fit
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device
    from repro_torch.train.trainer import TrainerConfig

    cfg = hybrid_train_config()
    (B, T), seed = HYBRID_TRAIN_BT, 0
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
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_hybrid_", dir=build_dir)
    try:
        config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=1000, log_every=1,
            ckpt_dir=ckpt_dir))
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = fit(cfg, config, seed=seed,
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
    want = hybrid_launches(cfg, TRAIN_STEPS, train=True)
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    step1_rel = abs(hist[0]["loss"] - plain_loss0) / abs(plain_loss0)
    emit("train_hybrid", arch=HYBRID_ARCH, batch=B, seq_len=T,
         n_layers=cfg.n_layers, reduced={"n_layers": f"81 -> {cfg.n_layers}"},
         steps=steps, launches=launches, launches_expected=want,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         step_s=step_s, tokens_per_s_steps_2_3=tok_s, fit_s=fit_s,
         peak_mem_gb=peak_gb,
         mem_allocated_gb={"before_fit": mem_before_gb,
                           "after_release": torch.cuda.memory_allocated() / 1e9},
         step1_loss=hist[0]["loss"], plain_loss_step1=plain_loss0,
         step1_rel_err=step1_rel, step1_tol=STEP1_TOL,
         checkpoint_files=written, finite=finite)
    if len(hist) != TRAIN_STEPS or not finite:
        raise SystemExit(f"hybrid training did not give {TRAIN_STEPS} finite steps")
    if launches != want:
        raise SystemExit(f"hybrid training launches {launches}, expected {want}")
    if step1_rel > STEP1_TOL:
        raise SystemExit(f"hybrid step 1 loss {hist[0]['loss']} vs the plain "
                         f"path's {plain_loss0}")
    if written:
        raise SystemExit(f"hybrid training wrote a checkpoint: {written}")
    return launches, {"step_s": step_s, "tokens_per_s": tok_s,
                      "peak_mem_gb": peak_gb}


# gradient leaves of zamba2 that the kernels feed and that must train
HYBRID_LIVE = ("shared.attn.wq", "shared.attn.wk", "shared.attn.wv",
               "shared.mlp.w_up", "shared.mlp.w_gate", "shared.mlp.w_down",
               "adapt_in", "adapt_out", "groups.ssm.in_proj", "groups.ssm.A_log",
               "tail.ssm.in_proj")


def run_train_contract_hybrid():
    """Every gradient of the loss with the kernels (K1, K2 / K3, K5) against
    the plain versions, at full width and 27 layers (batch 1 x 512: two
    chunks of 256); every gradient finite, the shared block's, the
    adapters' and the SSD projections' non-zero."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, value_and_grad

    cfg = hybrid_train_config()
    torch.cuda.reset_peak_memory_stats()
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
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            bad.append(f"{name} not finite")
        if name in HYBRID_LIVE and not bool(a.abs().sum() > 0):
            bad.append(f"{name} zero")
    worst = max(rel.values())
    emit("train_contract_hybrid", arch=HYBRID_ARCH, batch=1, seq_len=512,
         n_layers=cfg.n_layers, reduced={"n_layers": f"81 -> {cfg.n_layers}"},
         loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
         rel_grad_err=rel, max_rel_grad_err=worst, tol=TRAIN_CONTRACT_TOL,
         bad_grads=bad, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del g_k, g_p, params
    free_memory()
    if bad or worst > TRAIN_CONTRACT_TOL:
        raise SystemExit(f"hybrid training contract failed: max rel err {worst}, "
                         f"{bad}")


# ---------------------------------------------------------------------------
# The audio family (whisper-medium) and the VLM (llama-3.2-vision-90b at 10
# layers): K1/K2/K3 non-causal and cross-shaped
# ---------------------------------------------------------------------------


def vlm_config():
    """llama-3.2-vision-90b at the depth it serves at on one card."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)


def cross_launches(cfg, steps: int = 1, train: bool = False) -> dict:
    """K1 once per attention of a forward: the audio family's encoder
    layers and its decoder layers' self and cross attention; the VLM's self
    and cross blocks.  A training step runs each forward twice (per-layer
    remat) and K2 / K3 once per attention."""
    from repro_torch.kernels import LAUNCHES
    n = (cfg.enc_layers + 2 * cfg.n_layers if cfg.family == "audio"
         else cfg.n_layers)
    want = dict.fromkeys(LAUNCHES, 0)
    want["flash_attention_fwd"] = (2 if train else 1) * n * steps
    if train:
        want["flash_attention_bwd_dq"] = want["flash_attention_bwd_dkv"] = n * steps
    return want


def unit_memory(cfg, batch, gen):
    """The family's frontend input at unit scale, N(0, 1): the contracts'
    memory moves the logits as much as the tokens do (``generate`` draws
    0.02 N(0, 1))."""
    from repro_torch.models.api import MODALITY
    key, rows = MODALITY[cfg.family]
    return {key: torch.randn((batch, getattr(cfg, rows), cfg.d_model),
                             generator=gen, device=gen.device)}


def open_gates(params, value=VLM_GATE):
    for g in ("gate_a", "gate_m"):
        params["cross_blocks"][g].fill_(value)


def run_main_cross(phase, cfg, serve):
    """``generate`` of a cross-attention family (its frontend input drawn by
    ``generate``), launch counts reset just before and read just after."""
    from repro_torch.api import generate
    from repro_torch.kernels import LAUNCHES, reset_launches

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res = generate(cfg, seed=0, **serve)
    launches = dict(LAUNCHES)
    toks = res["tokens"]
    want = cross_launches(cfg)
    emit(phase, arch=cfg.arch_id, **serve, n_layers=cfg.n_layers,
         enc_layers=cfg.enc_layers, launches=launches, launches_expected=want,
         tokens_shape=list(toks.shape), prefill_s=res["prefill_s"],
         decode_s=res["decode_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches != want:
        raise SystemExit(f"expected {want} launches in {cfg.arch_id} generate, "
                         f"got {launches}")
    shape = (serve["batch"], serve["gen_tokens"])
    if toks.shape != shape or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise SystemExit(f"bad tokens: shape {toks.shape}, "
                         f"range [{toks.min()}, {toks.max()}]")
    return launches


def run_contract_cross(phase, cfg):
    """Prefill plus stepwise decode (f32 cache) against the full forward,
    and the forward with the kernels against the plain forward, at full
    width, batch 2 x 40 (prefill 32), over a unit-scale memory; the VLM's
    gates at VLM_GATE, and how far closing them moves the logits (over the
    tolerance, or the contract could not see the cross blocks)."""
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.models.prefill import prefill

    model = build_model(cfg)                       # kernels on, cuda
    gen = generator(model.device, 1)
    params = model.init(gen)
    if cfg.family == "vlm":
        open_gates(params)
    B, T, t0 = 2, 40, 32
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=model.device)
    memory = unit_memory(cfg, B, gen)
    feed = {"tokens": tokens, **memory}
    full, _ = model.forward(params, feed)
    plain = build_model(cfg, use_kernels=False).forward(params, feed)[0]
    finite = bool(torch.isfinite(full).all())
    kernel_vs_plain = (full - plain).abs().max().item()
    del plain
    gates_moved = None
    if cfg.family == "vlm":
        open_gates(params, 0.0)
        gates_moved = (model.forward(params, feed)[0] - full).abs().max().item()
        open_gates(params)
    last, cache = prefill(cfg, params, {"tokens": tokens[:, :t0], **memory},
                          cache_len=T, cache_dtype=torch.float32,
                          use_kernels=True)
    errs = [(last[:, 0] - full[:, t0 - 1]).abs().max().item()]
    for t in range(t0, T):
        lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], t)
        errs.append((lg[:, 0] - full[:, t]).abs().max().item())
    emit(phase, arch=cfg.arch_id, batch=B, tokens=T, prefill_len=t0,
         n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
         logits_shape=list(full.shape), finite=finite,
         cache_shapes={k: list(v.shape) for k, v in cache.items()},
         max_abs_logit=full.abs().max().item(),
         max_abs_err_decode_vs_forward=max(errs),
         max_abs_err_kernel_vs_plain_forward=kernel_vs_plain, tol=CONTRACT_TOL,
         **({"gate": VLM_GATE, "max_abs_logit_change_gates_closed": gates_moved}
            if gates_moved is not None else {}))
    del params, full, cache
    free_memory()
    if not finite or max(errs) > CONTRACT_TOL or kernel_vs_plain > CONTRACT_TOL:
        raise SystemExit(f"{cfg.arch_id} serving contract failed at full width")
    if gates_moved is not None and gates_moved <= CONTRACT_TOL:
        raise SystemExit(f"{cfg.arch_id}: the cross blocks move the logits by "
                         f"{gates_moved}, under the contract's tolerance")


def run_train_audio():
    """whisper-medium's training at full width and depth through
    ``make_train_step`` under ``fit(train_step=..., state=...)``: the step
    adds the frames (drawn as ``generate`` draws them) to each batch of
    fit's pipeline, which makes tokens only; no checkpoint is written."""
    from repro_torch.api import HarpConfig, fit
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model, modality_inputs
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import batch_to_device, make_train_step
    from repro_torch.train.trainer import TrainerConfig

    cfg = get_config(AUDIO_ARCH)
    (B, T), seed = AUDIO_TRAIN_BT, 0
    step_fn, model, opt_init = make_train_step(cfg, OptimizerConfig(
        warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS))
    gen = generator(model.device, seed)
    params = model.init(gen)
    frames = modality_inputs(cfg, B, gen)
    batch0 = batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, B, seed), 0),
                             model.device)
    plain = build_model(cfg, use_kernels=False, remat=False)
    with torch.no_grad():
        plain_loss0 = plain.loss(params, {**batch0, **frames})[0].item()
    del batch0
    free_memory()
    mem_before_gb = torch.cuda.memory_allocated() / 1e9

    def train_step(params, opt_state, batch):
        return step_fn(params, opt_state, {**batch, **frames})

    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_audio_", dir=build_dir)
    try:
        config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
            total_steps=TRAIN_STEPS, ckpt_every=1000, log_every=1,
            ckpt_dir=ckpt_dir))
        state = {"params": params, "opt_state": opt_init(params)}
        del params
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        res = fit(cfg, config, train_step=train_step, state=state, seed=seed,
                  log_fn=lambda m: print(m, file=sys.stderr, flush=True))
        fit_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        written = os.listdir(ckpt_dir)
        del res["state"], state
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    free_memory()
    hist = res["history"]
    steps = [{k: h[k] for k in ("step", "time_s", "loss", "grad_norm", "lr",
                                "accuracy")} for h in hist]
    step_s = [h["time_s"] for h in hist]
    tok_s = 2 * B * T / (step_s[1] + step_s[2])
    want = cross_launches(cfg, TRAIN_STEPS, train=True)
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    step1_rel = abs(hist[0]["loss"] - plain_loss0) / abs(plain_loss0)
    emit("train_audio", arch=AUDIO_ARCH, batch=B, seq_len=T,
         enc_frames=cfg.enc_frames, steps=steps, launches=launches,
         launches_expected=want,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         step_s=step_s, tokens_per_s_steps_2_3=tok_s, fit_s=fit_s,
         peak_mem_gb=peak_gb,
         mem_allocated_gb={"before_fit": mem_before_gb,
                           "after_release": torch.cuda.memory_allocated() / 1e9},
         step1_loss=hist[0]["loss"], plain_loss_step1=plain_loss0,
         step1_rel_err=step1_rel, step1_tol=STEP1_TOL,
         checkpoint_files=written, finite=finite)
    if len(hist) != TRAIN_STEPS or not finite:
        raise SystemExit(f"audio training did not give {TRAIN_STEPS} finite steps")
    if launches != want:
        raise SystemExit(f"audio training launches {launches}, expected {want}")
    if step1_rel > STEP1_TOL:
        raise SystemExit(f"audio step 1 loss {hist[0]['loss']} vs the plain "
                         f"path's {plain_loss0}")
    if written:
        raise SystemExit(f"audio training wrote a checkpoint: {written}")
    return launches


# gradient leaves of whisper that the kernels feed and that must train; the
# encoder's reach the loss only through the decoder's cross attention
AUDIO_LIVE = ("enc_blocks.attn.wq", "enc_blocks.attn.wk", "enc_blocks.attn.wv",
              "enc_blocks.mlp.w_up", "dec_blocks.attn.wq", "dec_blocks.xattn.wq",
              "dec_blocks.xattn.wk", "dec_blocks.xattn.wv", "pos_embed")


def run_train_contract_audio():
    """Every gradient of the loss with the kernels (K1, K2 / K3) against
    plain attention, at full width and depth, batch 1 x 448 over 1500
    unit-scale frames; every gradient finite, the encoder's and the
    attention projections' non-zero."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.models import build_model
    from repro_torch.train.step import batch_to_device, value_and_grad

    cfg = get_config(AUDIO_ARCH)
    T = AUDIO_TRAIN_BT[1]
    torch.cuda.reset_peak_memory_stats()
    kern = build_model(cfg)                               # kernels on, remat
    plain = build_model(cfg, use_kernels=False)
    gen = generator(kern.device, 2)
    params = kern.init(gen)
    batch = {**batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, 1, 2), 0),
                               kern.device), **unit_memory(cfg, 1, gen)}
    loss_k, _, g_k = value_and_grad(kern.loss, params, batch)
    loss_p, _, g_p = value_and_grad(plain.loss, params, batch)
    rel, bad = {}, []
    for (path, a), (_, b) in zip(_leaves(g_k), _leaves(g_p)):
        name = ".".join(path)
        rel[name] = ((a - b).norm() / b.norm()).item()
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            bad.append(f"{name} not finite")
        if name in AUDIO_LIVE and not bool(a.abs().sum() > 0):
            bad.append(f"{name} zero")
    worst = max(rel.values())
    emit("train_contract_audio", arch=AUDIO_ARCH, batch=1, seq_len=T,
         enc_frames=cfg.enc_frames, loss_kernels=loss_k.item(),
         loss_plain=loss_p.item(), rel_grad_err=rel, max_rel_grad_err=worst,
         tol=TRAIN_CONTRACT_TOL, bad_grads=bad,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del g_k, g_p, params
    free_memory()
    if bad or worst > TRAIN_CONTRACT_TOL:
        raise SystemExit(f"audio training contract failed: max rel err {worst}, "
                         f"{bad}")


# ---------------------------------------------------------------------------
# HARP's inter-operator pipeline: full-width gpt-2b in two stages
# ---------------------------------------------------------------------------


def pipeline_launches(cfg, stages, n_mb, steps=1) -> dict:
    """Per step, every stage runs its layers in every one of the n_mb + S - 1
    slots (the warm-up and drain slots too, masked by multiplication, as in
    the reference): K1 once in the forward and once in the slot's remat
    recompute, K2 and K3 once in the backward."""
    per = (n_mb + stages - 1) * cfg.n_layers
    return {"flash_attention_fwd": 2 * per * steps,
            "flash_attention_bwd_dq": per * steps,
            "flash_attention_bwd_dkv": per * steps,
            "ssd_intra": 0, "rmsnorm": 0}


@contextlib.contextmanager
def act_dtype(dtype):
    """The single-pod model's activations in ``dtype`` (cast at the
    embedding), as the pipeline's ``act_dtype`` runs them."""
    from repro_torch.models import common
    common.set_act_dtype(dtype)
    try:
        yield
    finally:
        common.set_act_dtype(None)


def run_pipeline(train_losses):
    """``make_pipeline_train_step("gpt-2b")`` at full width: 2 stages of 16
    layers, 4 microbatches of 2 x 1024, bf16 activations, the local
    transport, 3 steps, with the AdamW that ``fit`` builds for 3 steps, from
    ``fit``'s init and batches: ``train_losses``, the ``train`` phase's (f32
    activations, one batch of 8), go on the line beside its losses."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.parallel.staging import unstage
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import batch_to_device, make_pipeline_train_step

    cfg = get_config("gpt-2b")
    (B, T), S, n_mb, seed = PIPE_BT, PIPE_STAGES, PIPE_MB, 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, st, opt_init, specs = make_pipeline_train_step(
        cfg, OptimizerConfig(warmup_steps=min(20, TRAIN_STEPS),
                             total_steps=TRAIN_STEPS), n_stages=S,
        n_microbatches=n_mb, act_dtype=torch.bfloat16)
    build_s = time.perf_counter() - t0
    staged, shared = st.staged, st.shared
    dev = shared["embed"].device
    batches = [batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, B, seed), i),
                               dev) for i in range(TRAIN_STEPS)]
    # the single-pod loss of step 1's params and batch (before the update,
    # which is in place), in bf16 activations as the stages run and in f32
    params = unstage(cfg, staged, shared)
    with torch.no_grad():
        with act_dtype(torch.bfloat16):
            single_bf16 = build_model(cfg).loss(params, batches[0])[0].item()
        single_f32 = build_model(cfg).loss(params, batches[0])[0].item()
    del params
    free_memory()
    opt = opt_init({"staged": staged, "shared": shared})
    mem_state_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist, per_step = [], []
    for i in range(TRAIN_STEPS):
        before = dict(LAUNCHES)
        t1 = time.perf_counter()
        staged, shared, opt, m = step(staged, shared, st.consts, opt, batches[i])
        torch.cuda.synchronize()
        hist.append({"step": i + 1, "time_s": time.perf_counter() - t1,
                     **{k: v.item() for k, v in m.items()}})
        per_step.append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = pipeline_launches(cfg, S, n_mb)
    tok_s = 2 * B * T / (hist[1]["time_s"] + hist[2]["time_s"])
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    rel = abs(hist[0]["loss"] - single_bf16) / abs(single_bf16)
    rel_f32 = abs(hist[0]["loss"] - single_f32) / abs(single_f32)
    emit("pipeline", arch="gpt-2b", stages=S, layers_per_stage=cfg.n_layers // S,
         microbatches=n_mb, batch=B, seq_len=T, act_dtype="bfloat16",
         transport="local", steps=hist, launches=launches,
         launches_per_step=per_step, launches_expected_per_step=want,
         flash_shape=list(PIPE_TRAIN), tokens_per_s_steps_2_3=tok_s,
         build_s=build_s, peak_mem_gb=peak_gb, mem_state_gb=mem_state_gb,
         step1_loss=hist[0]["loss"], single_pod_loss_bf16=single_bf16,
         single_pod_loss_f32=single_f32, step1_rel_err_bf16=rel,
         step1_rel_err_f32=rel_f32, step1_tol_bf16=PIPE_STEP1_TOL,
         step1_tol_f32=PIPE_STEP1_F32_TOL, finite=finite,
         train_phase_losses_f32=train_losses,
         consts_specs=specs["consts"])
    del staged, shared, opt, st, step, batches
    free_memory()
    if not finite:
        raise SystemExit("the pipeline did not give finite losses")
    if any(ps != want for ps in per_step):
        raise SystemExit(f"pipeline launches per step {per_step}, expected {want}")
    if rel > PIPE_STEP1_TOL or rel_f32 > PIPE_STEP1_F32_TOL:
        raise SystemExit(f"pipeline step 1 loss {hist[0]['loss']} vs the single "
                         f"pod's {single_bf16} (bf16) / {single_f32} (f32)")
    return launches, {"tokens_per_s": tok_s, "peak_mem_gb": peak_gb,
                      "step_s": [h["time_s"] for h in hist]}


def run_pipeline_contract():
    """At full width, batch 2 x 256 in 2 microbatches, f32: the pipeline's
    loss and every gradient (unstaged to the model's layout) against the
    single-pod ``value_and_grad(model.loss)``, both with the kernels, and the
    pipeline with the kernels against the pipeline on the plain path.  The
    embedding table is rounded to bf16 first: the pipeline's ``make_io``
    rounds its input to bf16 (as the reference's does), which a table bf16
    holds makes exact; the embedding's gradient still comes back through
    bf16 (PIPE_EMBED_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.device import generator
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.parallel.pipeline import pipeline_loss_fn
    from repro_torch.parallel.staging import build_staging, unstage
    from repro_torch.train.step import batch_to_device, value_and_grad

    cfg = get_config("gpt-2b")
    B, T, S, n_mb = 2, 256, PIPE_STAGES, 2
    model = build_model(cfg)
    params = model.init(generator(model.device, 4))
    params["embed"].copy_(params["embed"].bfloat16().float())
    batch = batch_to_device(make_batch(DataConfig(cfg.vocab_size, T, B, 4), 0),
                            model.device)
    loss_s, _, g_s = value_and_grad(model.loss, params, batch)

    def pipeline_grads(use_kernels):
        st = build_staging(cfg, S, params, act_dtype=torch.float32,
                           use_kernels=use_kernels)
        loss_fn = pipeline_loss_fn(st, n_mb)
        reset_launches()
        loss, _, g = value_and_grad(
            lambda t, b: loss_fn(t["staged"], t["shared"], st.consts, b),
            {"staged": st.staged, "shared": st.shared}, batch)
        return loss, unstage(cfg, g["staged"], g["shared"]), dict(LAUNCHES)

    def rel_errs(got, want):
        return {".".join(path): ((a - _get(want, path)).norm()
                                 / _get(want, path).norm()).item()
                for path, a in _leaves(got)}

    loss_k, g_k, launches_k = pipeline_grads(True)
    vs_single = rel_errs(g_k, g_s)
    del g_s
    free_memory()
    loss_p, g_p, launches_p = pipeline_grads(False)
    vs_plain = rel_errs(g_k, g_p)
    finite = all(bool(torch.isfinite(a).all()) for _, a in _leaves(g_k))
    del g_k, g_p, params
    free_memory()
    worst_single = max(v for k, v in vs_single.items() if k != "embed")
    worst_plain = max(vs_plain.values())
    loss_rel = abs(loss_k.item() - loss_s.item()) / loss_s.item()
    loss_rel_plain = abs(loss_k.item() - loss_p.item()) / loss_p.item()
    want = pipeline_launches(cfg, S, n_mb)
    emit("pipeline_contract", arch="gpt-2b", stages=S, microbatches=n_mb,
         batch=B, seq_len=T, act_dtype="float32",
         loss_pipeline=loss_k.item(), loss_single_pod=loss_s.item(),
         loss_pipeline_plain=loss_p.item(), loss_rel_err=loss_rel,
         loss_rel_err_plain=loss_rel_plain, loss_tol=PIPE_LOSS_TOL,
         rel_grad_err_vs_single_pod=vs_single,
         rel_grad_err_vs_plain_pipeline=vs_plain,
         max_rel_grad_err_vs_single_pod=worst_single,
         embed_rel_grad_err_vs_single_pod=vs_single["embed"],
         max_rel_grad_err_vs_plain_pipeline=worst_plain,
         tol=PIPE_CONTRACT_TOL, embed_tol=PIPE_EMBED_TOL, finite=finite,
         launches_kernels=launches_k, launches_plain=launches_p,
         launches_expected=want, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if (not finite or loss_rel > PIPE_LOSS_TOL or loss_rel_plain > PIPE_LOSS_TOL
            or worst_single > PIPE_CONTRACT_TOL or worst_plain > PIPE_CONTRACT_TOL
            or vs_single["embed"] > PIPE_EMBED_TOL):
        raise SystemExit("pipeline contract failed at full width")
    if launches_k != want or any(launches_p.values()):
        raise SystemExit(f"pipeline contract launches {launches_k} / "
                         f"{launches_p}, expected {want} / none")


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


def run_compile(table, fp, train_launches, train_summary):
    """HARP's own entry point at full width: ``api.plan`` of gpt-2b on the
    H100 fleet priced from the card's kbench table, the Plan through JSON
    and back into ``api.compile``, ``attach_elastic`` and ``fit`` for 3
    steps on the card, with the drift ledger and a run-log attached.  The
    plan prices the fleet's meshes; ``fit`` trains the whole model on the
    card (as the reference's ``Executable.fit`` does), so the drift is a
    record, not a cost-model error."""
    from repro_torch import api
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.obs import ObsConfig, iter_kind, read_runlog
    from repro_torch.train.trainer import TrainerConfig

    free_memory()
    B, T = GPT2B_TRAIN[0], GPT2B_TRAIN[1]
    fleet = h100_fleet()
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_compile_", dir=build_dir)
    try:
        run_log = os.path.join(work, "run.jsonl")
        cfg = api.HarpConfig(
            seq_len=T, global_batch=B,
            planner=PlannerConfig(n_microbatches=B),
            kbench=api.KBenchConfig(table=table.to_dict(),
                                    device_map={"H100-80G": fp}),
            trainer=TrainerConfig(total_steps=TRAIN_STEPS, log_every=1,
                                  ckpt_dir=os.path.join(work, "ckpt")),
            obs=ObsConfig(run_log=run_log))
        t0 = time.perf_counter()
        plan = api.plan("gpt-2b", fleet, cfg)
        plan_s = time.perf_counter() - t0
        plan_path = os.path.join(work, "plan.json")
        with open(plan_path, "w") as f:
            f.write(plan.to_json())
        with open(plan_path) as f:
            text = f.read()
        exe = api.compile(plan_artifact=api.Plan.from_json(text))
        round_trip = exe.plan.to_json() == text == plan.to_json()
        ctrl = exe.attach_elastic()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t1 = time.perf_counter()
        res = exe.fit(seed=0, log_fn=lambda m: print(m, file=sys.stderr, flush=True))
        fit_s = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hist = res["history"]
        del res
        free_memory()
        drift = exe.drift_report()
        step_lines = list(iter_kind(read_runlog(run_log), "step"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, train_summary["losses"])]
    decisions = [d.describe() for d in ctrl.decisions]
    want_observed = TRAIN_STEPS - ctrl.cfg.telemetry_warmup_steps
    emit("compile", arch="gpt-2b", fleet=fleet.describe(), batch=B, seq_len=T,
         plan_s=plan_s, est_step_time=plan.strategy.est_step_time,
         stages=[{"subcluster": fleet.subclusters[st.cluster_idx].name,
                  "layers": st.layer_end - st.layer_start, "tp": st.tp, "dp": st.dp}
                 for st in plan.strategy.stages],
         plan_json_round_trip=round_trip, fit_s=fit_s,
         step_times_s=[h["time_s"] for h in hist], losses=losses,
         train_losses=train_summary["losses"], loss_rel_err=rel, loss_tol=STEP1_TOL,
         peak_mem_gb=peak_gb, train_peak_mem_gb=train_summary["peak_mem_gb"],
         launches=launches, launches_expected=train_launches,
         run_log_steps=len(step_lines), drift=drift.to_dict(),
         drift_observed=drift.n_observed, drift_observed_expected=want_observed,
         decisions=decisions)
    if not round_trip:
        raise SystemExit("the Plan did not round-trip bit-identically through JSON")
    if len(hist) != TRAIN_STEPS or max(rel) > STEP1_TOL:
        raise SystemExit(f"compile -> fit losses {losses} vs the train phase's "
                         f"{train_summary['losses']}")
    if launches != train_launches:
        raise SystemExit(f"compile -> fit launches {launches}, the train "
                         f"phase's {train_launches}")
    if len(step_lines) != TRAIN_STEPS:
        raise SystemExit(f"the run log has {len(step_lines)} step lines")
    if drift.n_observed != want_observed:
        raise SystemExit(f"the drift ledger observed {drift.n_observed} steps, "
                         f"expected {want_observed}")
    if ctrl.decisions[0].reason != "seeded from compiled plan":
        raise SystemExit(f"first controller decision: {decisions[0]}")
    return launches


def run_launcher(name, cwd, *argv):
    """``python -m repro_torch.launch.<name> ARGV`` in a fresh interpreter
    in ``cwd`` (its default checkpoint directory lands there): exit code,
    seconds, whether it printed its deprecation warning, and its result
    line (the loss or the sampled tokens)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"repro_torch.launch.{name}", *argv],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    marker = {"train": "[train] loss", "serve": "[serve] sample"}[name]
    return {"argv": list(argv), "rc": res.returncode,
            "seconds": time.perf_counter() - t0,
            "deprecation_warning": (f"DeprecationWarning: repro_torch.launch.{name} "
                                    "is deprecated") in res.stderr,
            "result": [ln for ln in res.stdout.splitlines() if marker in ln],
            "stderr_tail": res.stderr[-600:] if res.returncode else ""}


def run_cli(table, fp):
    """The port's CLI in process (``repro_torch.api.cli.main``): ``kbench
    show`` of the card's table, ``plan`` from it on the H100 fleet (held to
    the planner priced from the same table in memory), ``kbench collect``
    of K4 on the card, and ``train --plan <mamba2-2.7b plan> --smoke`` on
    the card (K5)."""
    import contextlib
    import io

    from repro_torch.api import cluster_to_dict
    from repro_torch.api.cli import main as cli
    from repro_torch.configs import get_config
    from repro_torch.core.planner import HAPTPlanner, PlannerConfig
    from repro_torch.kbench.bridge import KBenchConfig
    from repro_torch.kbench.table import LatencyTable
    from repro_torch.kernels import LAUNCHES, reset_launches

    free_memory()
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=build_dir)
    seconds, outputs = {}, {}

    def run(name, *argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(list(argv))
        seconds[name] = time.perf_counter() - t0
        outputs[name] = buf.getvalue()
        if rc != 0:
            raise SystemExit(f"python -m repro_torch {' '.join(argv)}: exit {rc}")

    def strategy(d):
        d = dict(d, planner_meta={k: v for k, v in d["planner_meta"].items()
                                  if not k.startswith("time_")})
        return d

    def path(name):
        return os.path.join(work, name)

    try:
        table.save(path("ktable.json"))
        with open(path("fleet.json"), "w") as f:
            json.dump(cluster_to_dict(h100_fleet()), f)
        reset_launches()
        run("kbench_show", "kbench", "show", path("ktable.json"))
        plan_args = ["--cluster-file", path("fleet.json"), "--seq-len", "1024",
                     "--global-batch", "64", "--granularity", "128",
                     "--microbatches", "64", "--kbench-table", path("ktable.json"),
                     "--kbench-device-map", f"H100-80G={fp}"]
        run("plan", "plan", "--arch", "gpt-2b", *plan_args, "--explain-costs",
            "-o", path("gpt.json"))
        with open(path("gpt.json")) as f:
            cli_strategy = strategy(json.load(f)["strategy"])
        direct = HAPTPlanner(h100_fleet(), PlannerConfig(
            granularity=128, n_microbatches=64, kbench=KBenchConfig(
                table=table.to_dict(), device_map={"H100-80G": fp}))).plan(
            get_config("gpt-2b"), seq_len=1024, global_batch=64)
        same_plan = cli_strategy == strategy(json.loads(direct.to_json()))
        k4_before = LAUNCHES["rmsnorm"]
        run("kbench_collect", "kbench", "collect", "--ops", "rmsnorm",
            "--trials", "5", "--warmup", "2", "-o", path("k4.json"))
        k4_grew = LAUNCHES["rmsnorm"] - k4_before
        k4_cells = LatencyTable.load(path("k4.json")).entries
        run("plan_mamba", "plan", "--arch", "mamba2-2.7b", *plan_args,
            "-o", path("mamba.json"))
        ssd_before = LAUNCHES["ssd_intra"]
        run("train_smoke", "train", "--plan", path("mamba.json"), "--smoke",
            "--steps", "2", "--batch", "8", "--ckpt-dir", path("ckpt"))
        ssd_launched = LAUNCHES["ssd_intra"] - ssd_before
        launches = dict(LAUNCHES)
        launchers = {name: run_launcher(name, work, *argv) for name, argv in (
            ("train", ("--arch", "gpt-2b", "--smoke", "--steps", "2")),
            ("serve", ("--arch", "gpt-2b", "--smoke")))}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("cli", seconds=seconds, kbench_show=outputs["kbench_show"].splitlines()[0],
         plan_same_strategy_as_planner=same_plan,
         plan_stages=[{"cluster_idx": st["cluster_idx"],
                       "layers": st["layer_end"] - st["layer_start"]}
                      for st in cli_strategy["stages"]],
         plan_est_step_time=cli_strategy["est_step_time"],
         explain_costs=[ln for ln in outputs["plan"].splitlines()
                        if "source=" in ln],
         kbench_collect=outputs["kbench_collect"].strip(),
         k4_cells=[{"device": e.device, "shape": list(e.shape),
                    "median_s": e.median_s} for e in k4_cells],
         k4_launches_grew=k4_grew,
         train_smoke=outputs["train_smoke"].strip().splitlines()[-2:],
         ssd_launches=ssd_launched, launches=launches, launchers=launchers)
    for name, out in launchers.items():
        if out["rc"] != 0 or not out["deprecation_warning"] or not out["result"]:
            raise SystemExit(f"python -m repro_torch.launch.{name}: {out}")
    if not same_plan:
        raise SystemExit("the CLI's plan differs from the planner's on the same table")
    if k4_grew < 5 + 2 or not all(e.device == fp for e in k4_cells):
        raise SystemExit(f"kbench collect through the CLI: K4 grew by {k4_grew}, "
                         f"cells {k4_cells}")
    if ssd_launched <= 0 or "over 2 steps" not in outputs["train_smoke"]:
        raise SystemExit(f"train --smoke through the CLI launched K5 "
                         f"{ssd_launched} times: {outputs['train_smoke']}")
    return launches


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits on the host, so that equality is bit equality."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.element_size() == 4 else t


def one_card_cluster():
    """One H100 sub-cluster: one node of one card."""
    from repro_torch.core.cluster import GBPS, H100_80G, HeteroCluster, SubCluster
    return HeteroCluster(subclusters=(SubCluster(
        "meshH100x1", 1, 1, H100_80G, 450e9, 200 * GBPS),), cross_bw=5 * GBPS)


def mesh_resume(tree, shardings, cfg, work, name):
    """Resume ``fit`` of full-width gpt-2b for one step (step TRAIN_STEPS +
    1) on the card from ``tree`` placed by ``ckpt.reshard`` onto
    ``shardings``: DTensors are handed to ``fit`` as their local tensors
    (detached, the same storage), device leaves as they are.  Returns (the
    step's history entry, launches, seconds, what was placed)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.api import HarpConfig, fit
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import TrainerConfig

    B, T = GPT2B_TRAIN[0], GPT2B_TRAIN[1]
    t0 = time.perf_counter()
    placed = ckpt.reshard(tree, shardings)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    info = {"reshard_s": reshard_s, "placements": {}, "device_bytes": 0,
            "local_vs_shard_shape_mismatch": [], "not_sharing_storage": [],
            "not_placed": [], "off_device": []}

    def local(path, x, s):
        name = ".".join(path)
        if isinstance(x, DTensor):
            kind = str(x.placements)
            info["placements"][kind] = info["placements"].get(kind, 0) + 1
            y = x.to_local().detach()
            if y.data_ptr() != x.to_local().data_ptr():
                info["not_sharing_storage"].append(name)
            if tuple(y.shape) != s.shard_shape(x.shape):
                info["local_vs_shard_shape_mismatch"].append(name)
        else:
            if not isinstance(s, torch.device):
                info["not_placed"].append(name)
            y = x
        if y.device.type != "cuda" or isinstance(y, DTensor):
            info["off_device"].append(name)
        info["device_bytes"] += y.numel() * y.element_size()
        return y

    def unwrap(x, s, path=()):
        if isinstance(x, dict):
            return {k: unwrap(v, s[k], path + (k,)) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(unwrap(getattr(x, f), getattr(s, f), path + (f,))
                             for f in x._fields))
        return None if x is None else local(path, x, s)

    state = unwrap(placed, shardings)
    info["device_mem_gb"] = torch.cuda.memory_allocated() / 1e9
    step_fn, _, _ = make_train_step(
        cfg, OptimizerConfig(warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS),
        device="cuda")
    config = HarpConfig(seq_len=T, global_batch=B, trainer=TrainerConfig(
        total_steps=TRAIN_STEPS + 1, ckpt_every=10 ** 9, log_every=1,
        ckpt_dir=os.path.join(work, f"ckpt_{name}")))
    reset_launches()
    t0 = time.perf_counter()
    res = fit(cfg, config, train_step=step_fn, state=state, seed=0,
              start_step=TRAIN_STEPS, device="cuda",
              log_fn=lambda m: print(m, file=sys.stderr, flush=True))
    fit_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    hist = res["history"]
    del res, state, placed
    return hist, launches, fit_s, info


def mesh_compression(tree):
    """``compress_tree`` of full-width leaves (the embedding and layer 0's
    slices) on the card and on the CPU, two error-feedback steps: the
    leaves whose q, scale or residual differ in any bit, the wire bytes
    against ``compressed_wire_bytes``, and the card's seconds."""
    from repro_torch.comm.selector import compressed_wire_bytes
    from repro_torch.parallel import compression
    from repro_torch.train.optimizer import tree_leaves, tree_map

    params = tree["params"]
    host = {"embed": torch.from_numpy(np.asarray(params["embed"])),
            "layer0": tree_map(lambda x: torch.from_numpy(np.asarray(x[0])),
                               params["blocks"])}
    dev = tree_map(lambda x: x.to("cuda"), host)
    out = {"leaves": {".".join(p): list(x.shape) for p, x in _leaves(host)},
           "differ": [], "device_s": []}
    errs = [compression.init_error_feedback(host),
            compression.init_error_feedback(dev)]
    for step in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pay_d, errs[1] = compression.compress_tree(dev, errs[1])
        torch.cuda.synchronize()
        out["device_s"].append(time.perf_counter() - t0)
        pay_h, errs[0] = compression.compress_tree(host, errs[0])
        for (path, (q, s)), (_, (qd, sd)) in zip(
                _leaves(pay_h), _leaves(pay_d)):
            if not (torch.equal(_bits(q), _bits(qd))
                    and torch.equal(_bits(s), _bits(sd))):
                out["differ"].append(f"step {step} {'.'.join(path)} q/scale")
        for (path, e), (_, ed) in zip(_leaves(errs[0]), _leaves(errs[1])):
            if not torch.equal(_bits(e), _bits(ed)):
                out["differ"].append(f"step {step} {'.'.join(path)} residual")
    out["wire_bytes"] = compression.wire_bytes(pay_d)
    out["wire_bytes_priced"] = sum(compressed_wire_bytes(x.numel() * 4.0)
                                   for x in tree_leaves(host))
    out["f32_bytes"] = sum(x.numel() * 4 for x in tree_leaves(host))
    del dev, errs, pay_d, pay_h
    return out


def run_mesh(restored):
    """HARP's device meshes on the card.  A one-rank NCCL process group on
    ``cuda:0`` (an in-process ``HashStore``), ``api.compile`` of gpt-2b on
    one H100 and ``Executable.stage_mesh(0)``: a 1 x 1 ``("data",
    "model")`` ``DeviceMesh`` on cuda; the H100 stage of the H100 fleet's
    plan (1 x 2) refuses to build for want of a second rank.  ``restored``
    is the ``train`` phase's step-3 checkpoint of full-width gpt-2b as
    ``ckpt.restore`` gave it on the host (read once, there): placed by
    ``ckpt.reshard`` onto ``train_shardings`` (params and the AdamW moments
    as DTensors), and ``fit`` resumed for step 4 on their local tensors;
    then the same step from the restored tree moved with ``.to("cuda")``:
    the two losses and grad norms bit-equal, 64 K1 / 32 K2 / 32 K3 per
    resumed step.  int8 compression of full-width leaves on the card
    bit-equal to the CPU's."""
    import torch.distributed as dist

    from repro_torch.api import HarpConfig, compile as api_compile
    from repro_torch.configs import get_config
    from repro_torch.core.dp_search import SearchConfig
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptimizerConfig, make_optimizer, tree_map
    from repro_torch.train.step import train_shardings

    t_phase = time.perf_counter()
    free_memory()
    cfg = get_config("gpt-2b")
    B, T = GPT2B_TRAIN[0], GPT2B_TRAIN[1]
    want_launches = {"flash_attention_fwd": 2 * cfg.n_layers,
                     "flash_attention_bwd_dq": cfg.n_layers,
                     "flash_attention_bwd_dkv": cfg.n_layers,
                     "ssd_intra": 0, "rmsnorm": 0}
    step_restored, tree = restored
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=build_dir)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        group_s = time.perf_counter() - t0
        # the one-card plan: the planner's t_max candidates are exact (17
        # digits); at its default 4 the one-stage plan's time can round
        # below itself and the search reports the card infeasible
        plan_bt = dict(seq_len=T, global_batch=B)
        plan_cfg = HarpConfig(**plan_bt, planner=PlannerConfig(
            search=SearchConfig(tmax_round_digits=17)))
        exe = api_compile("gpt-2b", one_card_cluster(), plan_cfg)
        mesh = exe.stage_mesh(0)
        fleet = api_compile("gpt-2b", h100_fleet(), HarpConfig(
            **plan_bt, planner=PlannerConfig(granularity=32, n_microbatches=8)))
        h100 = [i for i, st in enumerate(fleet.strategy.stages)
                if st.cluster_idx == 0]
        two_card_error = None
        try:
            fleet.stage_mesh(h100[0])
        except ValueError as e:
            two_card_error = str(e)

        opt_init, _ = make_optimizer(OptimizerConfig(
            warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS))
        pshard, oshard = train_shardings(cfg, mesh, opt_init,
                                         build_model(cfg, device="cuda"))
        shardings = {"params": pshard, "opt_state": oshard}
        torch.cuda.reset_peak_memory_stats()
        hist_m, launches, fit_m_s, info = mesh_resume(
            tree, shardings, cfg, work, "mesh")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        free_memory()
        cuda = torch.device("cuda")
        on_device = {"params": tree_map(lambda _: cuda, pshard),
                     "opt_state": type(oshard)(cuda, tree_map(lambda _: cuda, oshard.mu),
                                               tree_map(lambda _: cuda, oshard.nu))}
        hist_d, launches_d, fit_d_s, info_d = mesh_resume(
            tree, on_device, cfg, work, "device")
        free_memory()
        comp = mesh_compression(tree)
        run_sharded(mesh, tree, cfg)
        free_memory()
        run_pipeline_sharded(tree, cfg)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)

    h_m, h_d = hist_m[0], hist_d[0]
    bit_equal = (h_m["loss"] == h_d["loss"] and h_m["grad_norm"] == h_d["grad_norm"]
                 and h_m["total_loss"] == h_d["total_loss"])
    finite = math.isfinite(h_m["loss"]) and math.isfinite(h_m["grad_norm"])
    emit("mesh", arch=cfg.arch_id, batch=B, seq_len=T, backend="nccl",
         seconds=time.perf_counter() - t_phase, group_s=group_s, mesh_shape=list(mesh.shape),
         mesh_dims=list(mesh.mesh_dim_names), mesh_device=mesh.device_type,
         mesh_ranks=mesh.mesh.tolist(),
         plan_stages=[(st.tp, st.dp) for st in exe.strategy.stages],
         fleet_h100_stage=h100[0] if h100 else None,
         two_card_stage_error=two_card_error, ckpt_step=step_restored,
         reshard_s=info["reshard_s"],
         placements=info["placements"], device_bytes=info["device_bytes"],
         device_mem_gb_after_reshard=info["device_mem_gb"],
         local_vs_shard_shape_mismatch=info["local_vs_shard_shape_mismatch"],
         local_equals_global_shape=not info["local_vs_shard_shape_mismatch"],
         not_sharing_storage=info["not_sharing_storage"],
         not_placed=info["not_placed"],
         off_device=info["off_device"] + info_d["off_device"],
         device_reshard_s=info_d["reshard_s"], device_bytes_plain=info_d["device_bytes"],
         step=h_m["step"], loss=h_m["loss"], grad_norm=h_m["grad_norm"],
         loss_plain_resume=h_d["loss"], grad_norm_plain_resume=h_d["grad_norm"],
         bit_equal=bit_equal, finite=finite, step_s=h_m["time_s"],
         step_s_plain_resume=h_d["time_s"], fit_s=fit_m_s, fit_s_plain_resume=fit_d_s,
         peak_mem_gb=peak_gb, launches=launches, launches_plain_resume=launches_d,
         launches_expected=want_launches, compression=comp)
    if tuple(mesh.shape) != (1, 1) or mesh.mesh_dim_names != ("data", "model") \
            or mesh.device_type != "cuda" or mesh.mesh.tolist() != [[0]]:
        raise SystemExit(f"stage_mesh(0) of the one-card plan is {mesh}")
    if not h100 or two_card_error is None:
        raise SystemExit("the fleet's two-card H100 stage did not refuse a "
                         "one-rank group")
    if step_restored != TRAIN_STEPS:
        raise SystemExit(f"restored step {step_restored}, not {TRAIN_STEPS}")
    if (info["local_vs_shard_shape_mismatch"] or info["not_sharing_storage"]
            or info["not_placed"] or info["off_device"] or info_d["off_device"]):
        raise SystemExit(f"placement: {info}")
    if h_m["step"] != TRAIN_STEPS + 1 or not finite or not bit_equal:
        raise SystemExit(f"resumed step: mesh {h_m}, device {h_d}")
    if launches != want_launches or launches_d != want_launches:
        raise SystemExit(f"resumed launches {launches} / {launches_d}, "
                         f"expected {want_launches}")
    if comp["differ"] or comp["wire_bytes"] != comp["wire_bytes_priced"]:
        raise SystemExit(f"compression on the card against the CPU: {comp}")
    return launches


SHARDED_REL_TOL = 1e-6
# the AdamW update of the sharded step against the plain step's, per leaf
# relative to the update's size: f32, where the two gradients differ at
# f32 rounding (the grad norm by an ulp)
SHARDED_UPDATE_TOL = 1e-5


def run_sharded(mesh, tree, cfg):
    """Sharded execution on the card: one ``make_train_step(act_rules=
    train_act_rules(), use_kernels=False)`` step of full-width gpt-2b at
    8 x 1024, f32, its params and AdamW state the ``train`` phase's step-3
    checkpoint (the host tree the ``mesh`` phase holds) placed by
    ``ckpt.reshard`` onto ``train_shardings`` of the 1 x 1 ``("data",
    "model")`` mesh and the batch a ``Shard(0)`` DTensor, against the same
    step on plain CUDA tensors from the same tree and batch.  Returns the
    emitted fields; raises on a failed gate: loss and grad norm bit-equal or
    within ``SHARDED_REL_TOL``, every leaf's local shape its
    ``shard_shape``, no kernel launched (the sharded path runs the plain
    path, as the reference's runs its jnp path), and the params, ``mu`` and
    ``nu`` that the two AdamW updates leave within ``SHARDED_UPDATE_TOL``
    of each other per leaf, relative to the size of the update."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.optimizer import (
        OptimizerConfig, make_optimizer, tree_leaves, tree_map,
    )
    from repro_torch.train.step import make_train_step, train_shardings

    B, T = GPT2B_TRAIN[0], GPT2B_TRAIN[1]
    opt_cfg = OptimizerConfig(warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS)
    opt_init, _ = make_optimizer(opt_cfg)
    pshard, oshard = train_shardings(cfg, mesh, opt_init, build_model(cfg, device="cuda"))
    shardings = {"params": pshard, "opt_state": oshard}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen, device="cuda")
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    step, _, _ = make_train_step(cfg, opt_cfg, act_rules=shd.train_act_rules(),
                                 use_kernels=False, device="cuda")
    out = {}

    def one(name, placed, feed):
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, _, m = step(placed["params"], placed["opt_state"], feed)
        loss, gn = (float(x.full_tensor() if isinstance(x, DTensor) else x)
                    for x in (m["loss"], m["grad_norm"]))
        torch.cuda.synchronize()
        out[name] = {"step_s": time.perf_counter() - t0, "loss": loss,
                     "grad_norm": gn, "launches": dict(LAUNCHES),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}

    def walk(x, sh, path=()):
        if isinstance(x, dict):
            for k in sorted(x):
                yield from walk(x[k], sh[k], path + (k,))
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                if getattr(x, f) is not None:
                    yield from walk(getattr(x, f), getattr(sh, f), path + (f,))
        else:
            yield path, x, sh

    placed = ckpt.reshard(tree, shardings)
    mismatch, not_dtensor = [], []
    for path, x, sh in walk(placed, shardings):
        if not isinstance(x, DTensor):
            not_dtensor.append(".".join(path))
        elif tuple(x.to_local().shape) != sh.shard_shape(tuple(x.shape)):
            mismatch.append(".".join(path))
    feed = tree_map(lambda sh, x: sh.distribute(x),
                    shd.batch_shardings(mesh, batch, "data"), batch)
    one("sharded", placed, feed)
    # what the update left, on the host beside the restored tree
    updated = {path: x.to_local().cpu() for path, x, _ in walk(placed, shardings)
               if path[0] == "params" or path[1] in ("mu", "nu")}
    del placed, feed
    free_memory()
    cuda = torch.device("cuda")
    on_device = {"params": tree_map(lambda _: cuda, pshard),
                 "opt_state": type(oshard)(cuda, tree_map(lambda _: cuda, oshard.mu),
                                           tree_map(lambda _: cuda, oshard.nu))}
    placed = ckpt.reshard(tree, on_device)
    one("plain", placed, batch)
    # per leaf, |sharded - plain| over |plain - restored|: the two updates'
    # difference against the update's own size, the largest per kind
    before = {path: x for path, x, _ in walk(tree, shardings)}
    update_rel = {}
    for path, x, _ in walk(placed, shardings):
        if path in updated and x.numel():
            kind = path[0] if path[0] == "params" else path[1]
            diff = torch.linalg.vector_norm(x - updated[path].to(cuda)).item()
            moved = torch.linalg.vector_norm(x - torch.as_tensor(before[path]).to(cuda)).item()
            update_rel[kind] = max(update_rel.get(kind, 0.0), diff / max(moved, 1e-30))
    del placed, updated
    free_memory()
    s_, p_ = out["sharded"], out["plain"]
    rel = {k: abs(s_[k] - p_[k]) / max(abs(p_[k]), 1e-30) for k in ("loss", "grad_norm")}
    bit_equal = s_["loss"] == p_["loss"] and s_["grad_norm"] == p_["grad_norm"]
    launched = {k: v for r in (s_, p_) for k, v in r["launches"].items() if v}
    fields = dict(arch=cfg.arch_id, batch=B, seq_len=T, dtype="float32",
                  mesh_shape=list(mesh.shape), mesh_device=mesh.device_type,
                  use_kernels=False, act_rules="train_act_rules",
                  leaves=len(tree_leaves(pshard)), local_vs_shard_shape_mismatch=mismatch,
                  not_dtensor=not_dtensor, step_s=s_["step_s"],
                  step_s_plain=p_["step_s"], loss=s_["loss"], loss_plain=p_["loss"],
                  grad_norm=s_["grad_norm"], grad_norm_plain=p_["grad_norm"],
                  rel_diff=rel, bit_equal=bit_equal, tol=SHARDED_REL_TOL,
                  update_rel=update_rel, update_tol=SHARDED_UPDATE_TOL,
                  launches=s_["launches"], launches_plain=p_["launches"],
                  peak_mem_gb=s_["peak_mem_gb"], peak_mem_gb_plain=p_["peak_mem_gb"],
                  nvidia_smi=nvidia_smi_line())
    emit("sharded", **fields)
    if mismatch or not_dtensor:
        raise SystemExit(f"sharded placement: {mismatch} {not_dtensor}")
    if launched:
        raise SystemExit(f"sharded phase launched kernels: {launched}")
    if not (math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])):
        raise SystemExit(f"sharded step not finite: {s_}")
    if not bit_equal and max(rel.values()) > SHARDED_REL_TOL:
        raise SystemExit(f"sharded step against the plain one: {rel}")
    if sorted(update_rel) != ["mu", "nu", "params"] or \
            max(update_rel.values()) > SHARDED_UPDATE_TOL:
        raise SystemExit(f"sharded AdamW update against the plain one: {update_rel}")
    return fields


def placement_faults(trees, shardings, sub):
    """(leaves whose local shape is not their ``shard_shape``, leaves that
    are not DTensors on ``sub``) of named trees and their
    :class:`NamedSharding` trees, as dotted paths."""
    from torch.distributed.tensor import DTensor

    mismatch, not_dtensor = [], []
    for name, tree in trees.items():
        for path, x in _leaves(tree):
            s = _get(shardings[name], path)
            if not (isinstance(x, DTensor) and x.device_mesh == sub):
                not_dtensor.append(".".join((name,) + path))
            elif tuple(x.to_local().shape) != s.shard_shape(tuple(x.shape)):
                mismatch.append(".".join((name,) + path))
    return mismatch, not_dtensor


def update_sizes(res, updated, before):
    """Per kind (params, ``mu``, ``nu``), the largest over the leaves of
    |sharded - plain| / |plain - before|: two updates' difference against
    the update's own size.  ``res`` holds the plain step's trees on the
    card, ``updated`` the sharded step's leaves on the host by (kind,
    *path), ``before`` the host trees before the step."""
    out = {}
    for kind, tree in res.items():
        for path, x in _leaves(tree):
            if x.numel():
                diff = torch.linalg.vector_norm(x - updated[(kind,) + path].to(x.device))
                moved = torch.linalg.vector_norm(x - _get(before[kind], path).to(x.device))
                out[kind] = max(out.get(kind, 0.0), diff.item() / max(moved.item(), 1e-30))
    return out


# the pipeline on DTensors: full-width gpt-2b, one stage, the `sharded`
# phase's batch of 8 x 1024 in PIPE_SHARDED_MB f32 microbatches of 2
PIPE_SHARDED_MB = 4


def run_pipeline_sharded(tree, cfg):
    """The pipeline's stage on DTensors on the card:
    ``make_pipeline_train_step(mesh=...)`` of full-width gpt-2b on a
    (1, 1, 1) ``("pod", "data", "model")`` cuda mesh (the ``mesh`` phase's
    one-rank NCCL group), one stage, ``PIPE_SHARDED_MB`` f32 microbatches
    of 2 x 1024, ``use_kernels=False``, its params and AdamW state the
    ``train`` phase's step-3 checkpoint (the host tree ``run_mesh`` holds)
    staged and cut by ``place_stage``, one step, against the same step of
    the local transport (S = 1) on plain CUDA tensors from the same tree and
    batch.  Raises on a failed gate: loss and grad norm bit-equal or within
    ``SHARDED_REL_TOL``; every leaf of the staging and the state a DTensor
    on the stage's sub-mesh with the local shape of its ``shard_shape``;
    the params, ``mu`` and ``nu`` that the two updates leave within
    ``SHARDED_UPDATE_TOL`` of each other per leaf, relative to the size of
    the update; no kernel launched.  With one stage there is no shift: the
    NCCL send and receive between stages stay unexercised on one card."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.staging import build_staging
    from repro_torch.train.optimizer import (
        OptimizerConfig, OptState, tree_leaves, tree_map,
    )
    from repro_torch.train.step import (
        make_pipeline_train_step, place_stage, stage_submesh,
    )

    B, T = GPT2B_TRAIN[0], GPT2B_TRAIN[1]
    opt_cfg = OptimizerConfig(warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS)
    cuda = torch.device("cuda")
    host = tree_map(lambda x: torch.from_numpy(np.asarray(x)), tree["params"])
    state = tree["opt_state"]

    def staged(t):
        """A model-layout tree as the one-stage staging's {staged, shared}."""
        st = build_staging(cfg, 1, tree_map(lambda x: torch.from_numpy(np.asarray(x)), t),
                           act_dtype=torch.float32, use_kernels=False)
        return {"staged": st.staged, "shared": st.shared}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen, device="cuda")
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device_type="cuda")
    sub, _ = stage_submesh(mesh)
    out = {}

    def one(name, step, st, opt):
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new_staged, new_shared, opt, m = step(st.staged, st.shared, st.consts, opt, batch)
        loss, gn = (float(x.full_tensor() if isinstance(x, DTensor) else x)
                    for x in (m["total_loss"], m["grad_norm"]))
        torch.cuda.synchronize()
        out[name] = {"step_s": time.perf_counter() - t0, "loss": loss,
                     "grad_norm": gn, "launches": dict(LAUNCHES),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        return {"params": {"staged": new_staged, "shared": new_shared},
                "mu": opt.mu, "nu": opt.nu}

    t0 = time.perf_counter()
    step, st, _, shardings = make_pipeline_train_step(
        cfg, opt_cfg, n_stages=1, n_microbatches=PIPE_SHARDED_MB,
        act_dtype=torch.float32, params=host, use_kernels=False, device="cuda",
        mesh=mesh)
    specs = {k: shardings[f"{k}_specs"] for k in ("staged", "shared")}
    opt = OptState(distribute_tensor(torch.tensor(int(np.asarray(state.step)),
                                                  dtype=torch.int32, device=cuda),
                                     sub, [Replicate()] * sub.ndim),
                   place_stage(staged(state.mu), specs, mesh, cuda),
                   place_stage(staged(state.nu), specs, mesh, cuda))
    place_s = time.perf_counter() - t0
    both = {"staged": shardings["staged"], "shared": shardings["shared"]}
    mismatch, not_dtensor = placement_faults(
        {"staged": st.staged, "shared": st.shared, "consts": st.consts,
         "mu": opt.mu, "nu": opt.nu},
        {**{k: shardings[k] for k in ("staged", "shared", "consts")},
         "mu": both, "nu": both}, sub)
    res = one("sharded", step, st, opt)
    # what the update left, on the host
    updated = {(kind,) + path: (x.to_local() if isinstance(x, DTensor) else x).cpu()
               for kind, tr in res.items() for path, x in _leaves(tr)}
    n_leaves = len(tree_leaves(st.staged)) + len(tree_leaves(st.shared))
    del step, st, opt, res
    free_memory()

    step, st, _, _ = make_pipeline_train_step(
        cfg, opt_cfg, n_stages=1, n_microbatches=PIPE_SHARDED_MB,
        act_dtype=torch.float32, params=host, use_kernels=False, device="cuda")
    opt = OptState(torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                device=cuda),
                   tree_map(lambda x: x.to(cuda, copy=True), staged(state.mu)),
                   tree_map(lambda x: x.to(cuda, copy=True), staged(state.nu)))
    res = one("plain", step, st, opt)
    update_rel = update_sizes(res, updated, {
        "params": staged(tree["params"]), "mu": staged(state.mu),
        "nu": staged(state.nu)})
    del step, st, opt, res, updated
    free_memory()
    s_, p_ = out["sharded"], out["plain"]
    rel = {k: abs(s_[k] - p_[k]) / max(abs(p_[k]), 1e-30) for k in ("loss", "grad_norm")}
    bit_equal = s_["loss"] == p_["loss"] and s_["grad_norm"] == p_["grad_norm"]
    launched = {k: v for r in (s_, p_) for k, v in r["launches"].items() if v}
    fields = dict(arch=cfg.arch_id, stages=1, microbatches=PIPE_SHARDED_MB,
                  batch=B, seq_len=T, dtype="float32", mesh_shape=list(mesh.shape),
                  mesh_dims=list(mesh.mesh_dim_names), submesh_shape=list(sub.shape),
                  mesh_device=mesh.device_type, use_kernels=False,
                  act_rules="train_act_rules", ckpt_step=int(np.asarray(state.step)),
                  nccl_shift_exercised=False, leaves=n_leaves, place_s=place_s,
                  local_vs_shard_shape_mismatch=mismatch, not_dtensor=not_dtensor,
                  step_s=s_["step_s"], step_s_plain=p_["step_s"],
                  loss=s_["loss"], loss_plain=p_["loss"],
                  grad_norm=s_["grad_norm"], grad_norm_plain=p_["grad_norm"],
                  rel_diff=rel, bit_equal=bit_equal, tol=SHARDED_REL_TOL,
                  update_rel=update_rel, update_tol=SHARDED_UPDATE_TOL,
                  launches=s_["launches"], launches_plain=p_["launches"],
                  peak_mem_gb=s_["peak_mem_gb"], peak_mem_gb_plain=p_["peak_mem_gb"],
                  nvidia_smi=nvidia_smi_line())
    emit("pipeline_sharded", **fields)
    if mismatch or not_dtensor:
        raise SystemExit(f"pipeline_sharded placement: {mismatch} {not_dtensor}")
    if launched:
        raise SystemExit(f"pipeline_sharded phase launched kernels: {launched}")
    if not (math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])):
        raise SystemExit(f"pipeline_sharded step not finite: {s_}")
    if not bit_equal and max(rel.values()) > SHARDED_REL_TOL:
        raise SystemExit(f"pipeline_sharded step against the plain one: {rel}")
    if sorted(update_rel) != ["mu", "nu", "params"] or \
            max(update_rel.values()) > SHARDED_UPDATE_TOL:
        raise SystemExit(f"pipeline_sharded AdamW update against the plain one: "
                         f"{update_rel}")
    return fields


# the dry run's cells on the chip machine's host: one per kind the
# contract names; the train cells run one microbatch scaled by 16
# (REPRO_FAST_ANALYSIS, the reference's own mode) to fit the phase's time;
# the last is a pipelined multi-pod train cell, two stages each traced at
# its own rank
DRYRUN_CELLS = [
    ("gemma-2b", "train_4k", "single", {"REPRO_FAST_ANALYSIS": "1"}),
    ("gemma-2b", "prefill_32k", "single", {}),
    ("deepseek-7b", "decode_32k", "single", {}),
    ("mamba2-2.7b", "long_500k", "single", {}),
    ("zamba2-7b", "long_500k", "single", {}),
    ("granite-moe-1b-a400m", "train_4k", "single", {"REPRO_FAST_ANALYSIS": "1"}),
    ("granite-moe-1b-a400m", "decode_32k", "single", {}),
    ("minitron-8b", "decode_32k", "multi", {}),
    ("minitron-8b", "train_4k", "multi", {"REPRO_FAST_ANALYSIS": "1"}),
]


def run_dryrun():
    """The launcher's dry run at full published size on the 256- or
    512-rank fake process group, on the host: ``launch.dryrun.run_cell``
    for each of ``DRYRUN_CELLS``, every record ``ok`` and its argument bytes
    the sum of its leaves' ``shard_shape`` bytes (``build_case`` in a fake
    world of its own).  A pipelined cell's record holds two ``stages``, each
    traced at its own rank: each must be ``ok``, hold its own shard bytes
    and send over ``pod`` (``collective_permute@pod`` > 0).  These are host
    counts: nothing runs on the card."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dryrun_", dir=os.path.join(ROOT, "build"))
    failed = []
    try:
        for arch, shape, mk, env in DRYRUN_CELLS:
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            try:
                rec = D.run_cell(arch, shape, mk, work)
                ranks = [s["rank"] for s in rec.get("stages", [])] or [0]
                wants = []
                for rank in ranks:
                    with D.fake_world(mk, rank):
                        wants.append(D.shard_bytes(D.cell_case(arch, shape, mk)[0]))
                # the top level is the stage with the larger peak, the first
                # of equal ones, as ``run_cell`` takes it
                stages = rec.get("stages") or [rec]
                want = wants[max(range(len(stages)), key=lambda i: stages[i].get(
                    "memory", {}).get("peak_per_device", 0))]
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            mem = rec.get("memory", {})
            emit("dryrun", cell=f"{arch} x {shape} x {mk}", ok=rec["ok"],
                 error=rec.get("error"), host_counts_not_card_time=True,
                 world=D.world_size(mk), knobs=env or None,
                 analysis_mode=rec.get("analysis_mode"), trace_s=rec.get("trace_s"),
                 total_s=rec["total_s"], peak_per_device=mem.get("peak_per_device"),
                 argument_bytes=mem.get("argument_bytes"),
                 argument_bytes_from_shard_shapes=want,
                 output_bytes=mem.get("output_bytes"), alias_bytes=mem.get("alias_bytes"),
                 temp_bytes=mem.get("temp_bytes"),
                 flops_per_device=rec.get("flops_per_device"),
                 collectives=rec.get("collectives"),
                 collectives_by_mesh_dim=rec.get("collectives_by_mesh_dim"),
                 collective_bytes_per_device=rec.get("collective_bytes_per_device"),
                 stages=[dict(stage=st["stage"], rank=st["rank"], trace_s=st["trace_s"],
                              peak_per_device=st["memory"]["peak_per_device"],
                              argument_bytes=st["memory"]["argument_bytes"],
                              argument_bytes_from_shard_shapes=w,
                              alias_bytes=st["memory"]["alias_bytes"],
                              temp_bytes=st["memory"]["temp_bytes"],
                              flops_per_device=st.get("flops_per_device"),
                              collective_permute_pod=st.get(
                                  "collectives_by_mesh_dim", {}).get("collective_permute@pod"),
                              all_reduce_pod=st.get(
                                  "collectives_by_mesh_dim", {}).get("all_reduce@pod"),
                              collective_bytes_per_device=st.get("collective_bytes_per_device"))
                         for st, w in zip(rec.get("stages", []), wants)] or None)
            if not rec["ok"] or mem.get("argument_bytes") != want:
                failed.append((arch, shape, mk, rec.get("error")))
            if D.pipelined(D.get_config(arch), shape, mk == "multi"):
                stages = rec.get("stages", [])
                if len(stages) != 2 or any(
                        st["memory"]["argument_bytes"] != w
                        or not st.get("collectives_by_mesh_dim", {}).get(
                            "collective_permute@pod", 0) > 0
                        for st, w in zip(stages, wants)):
                    failed.append((arch, shape, mk, "pipelined stages"))
            if dist.is_initialized():
                failed.append((arch, shape, mk, "process group left initialised"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit("dryrun_total", seconds=time.perf_counter() - t_phase,
         cells=len(DRYRUN_CELLS), host_counts_not_card_time=True)
    if failed:
        raise SystemExit(f"dry-run cells failed: {failed}")


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
    t_start = time.perf_counter()
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
    fwd_errs, (fwd_share, fwd_share_case) = check_kernel_cases(gen)
    bwd_err = check_bwd_kernel_cases(gen)
    ssd_err = check_ssd_cases(gen)
    rms_err = check_rmsnorm_cases(gen)
    serve_launches = run_main_path()
    run_contract()
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=build_dir)
    atexit.register(shutil.rmtree, ckpt_dir, ignore_errors=True)
    # the step-3 checkpoint, read once: held on the host for the mesh phase
    train_launches, train_summary, train_restored = run_train(ckpt_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    run_train_contract()
    free_memory()                                # nothing of gpt-2b stays
    ssm_serve_launches = run_main_ssm()
    run_contract_ssm()
    ssm_train_launches, _ = run_train_ssm()
    run_train_contract_ssm()
    free_memory()
    moe_serve_launches = run_main_moe()
    run_contract_moe()
    moe_train_launches, _ = run_train_moe()
    run_train_contract_moe()
    free_memory()
    hybrid_serve_launches = run_main_hybrid()
    run_contract_hybrid()
    hybrid_train_launches, _ = run_train_hybrid()
    run_train_contract_hybrid()
    free_memory()
    from repro_torch.configs import get_config
    audio_serve_launches = run_main_cross("main_audio", get_config(AUDIO_ARCH),
                                          AUDIO_SERVE)
    free_memory()
    run_contract_cross("contract_audio", get_config(AUDIO_ARCH))
    free_memory()
    audio_train_launches = run_train_audio()
    free_memory()
    run_train_contract_audio()
    free_memory()
    vlm_serve_launches = run_main_cross("main_vlm", vlm_config(), VLM_SERVE)
    free_memory()
    run_contract_cross("contract_vlm", vlm_config())
    free_memory()
    pipe_launches, _ = run_pipeline(train_summary["losses"])
    free_memory()
    run_pipeline_contract()
    free_memory()
    table, fp, kbench_launches = run_kbench()
    run_plan(table, fp)
    compile_launches = run_compile(table, fp, train_launches, train_summary)
    cli_launches = run_cli(table, fp)
    free_memory()
    mesh_launches = run_mesh(train_restored)
    del train_restored
    free_memory()
    run_dryrun()
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

    def at_shape(kernel, case, err):
        """A flash kernel at another arch's shape: its f32 numbers there."""
        r = rows[(kernel, case, "float32")]
        return {"shape": list(case), "max_abs_err": err,
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    def pipeline_at(kernel):
        """A flash kernel at the pipeline's microbatch shape, in bf16."""
        r = rows[(kernel, PIPE_TRAIN, "bfloat16")]
        err = (fwd_errs[(PIPE_TRAIN, "bfloat16")] if kernel == "flash_attention_fwd"
               else bwd_err[(kernel, PIPE_TRAIN, "bfloat16")])
        return {"shape": list(PIPE_TRAIN), "dtype": "bfloat16", "max_abs_err": err,
                "tol": TOL["bfloat16"] if kernel == "flash_attention_fwd"
                else list(GRAD_TOL["bfloat16"]),
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    def ssd_at(case):
        """K5 at a zamba2-7b shape: its numbers there."""
        r = ssd_rows[case]
        return {"shape": list(case[:6]), "max_abs_err": ssd_err[case],
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "bound_simt_ms")}}

    bwd_src = "src/repro_torch/csrc/flash_attention_bwd.cu"
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        entry("flash_attention_fwd", "src/repro_torch/csrc/flash_attention_fwd.cu",
              "src/repro/kernels/ops.py:120", serve_launches["flash_attention_fwd"],
              fwd_errs[GPT2B_PREFILL], GPT2B_PREFILL, tol=TOL["float32"],
              launches_train=train_launches["flash_attention_fwd"],
              launches_compile=compile_launches["flash_attention_fwd"],
              launches_moe=moe_serve_launches["flash_attention_fwd"],
              launches_train_moe=moe_train_launches["flash_attention_fwd"],
              launches_hybrid=hybrid_serve_launches["flash_attention_fwd"],
              launches_train_hybrid=hybrid_train_launches["flash_attention_fwd"],
              granite_prefill=at_shape("flash_attention_fwd", GRANITE_PREFILL,
                                       fwd_errs[GRANITE_PREFILL]),
              granite_train=at_shape("flash_attention_fwd", GRANITE_TRAIN,
                                     fwd_errs[GRANITE_TRAIN]),
              zamba_prefill=at_shape("flash_attention_fwd", ZAMBA_PREFILL,
                                     fwd_errs[ZAMBA_PREFILL]),
              zamba_train=at_shape("flash_attention_fwd", ZAMBA_TRAIN,
                                   fwd_errs[ZAMBA_TRAIN]),
              launches_audio=audio_serve_launches["flash_attention_fwd"],
              launches_train_audio=audio_train_launches["flash_attention_fwd"],
              launches_vlm=vlm_serve_launches["flash_attention_fwd"],
              launches_pipeline=pipe_launches["flash_attention_fwd"],
              launches_mesh=mesh_launches["flash_attention_fwd"],
              pipeline=pipeline_at("flash_attention_fwd"),
              **{name: at_shape("flash_attention_fwd", case, fwd_errs[case])
                 for name, case in NEW_SHAPES.items()},
              train_ms=rows[("flash_attention_fwd", GPT2B_TRAIN, "float32")]["ms"],
              train_bound_ms=rows[("flash_attention_fwd", GPT2B_TRAIN, "float32")]["bound_ms"],
              train_library_ms=rows[("flash_attention_fwd", GPT2B_TRAIN,
                                     "float32")]["library_ms"],
              worst_f32_share_of_tol=fwd_share,
              worst_f32_share_case=list(fwd_share_case)),
        entry("flash_attention_bwd_dq", bwd_src,
              "src/repro/kernels/flash_attention.py:236",
              train_launches["flash_attention_bwd_dq"],
              bwd_err[("flash_attention_bwd_dq", GPT2B_TRAIN)], GPT2B_TRAIN,
              tol=GRAD_TOL["float32"],
              launches_compile=compile_launches["flash_attention_bwd_dq"],
              launches_train_moe=moe_train_launches["flash_attention_bwd_dq"],
              launches_train_hybrid=hybrid_train_launches["flash_attention_bwd_dq"],
              granite_train=at_shape(
                  "flash_attention_bwd_dq", GRANITE_TRAIN,
                  bwd_err[("flash_attention_bwd_dq", GRANITE_TRAIN)]),
              zamba_train=at_shape(
                  "flash_attention_bwd_dq", ZAMBA_TRAIN,
                  bwd_err[("flash_attention_bwd_dq", ZAMBA_TRAIN)]),
              launches_audio=audio_serve_launches["flash_attention_bwd_dq"],
              launches_train_audio=audio_train_launches["flash_attention_bwd_dq"],
              launches_vlm=vlm_serve_launches["flash_attention_bwd_dq"],
              launches_pipeline=pipe_launches["flash_attention_bwd_dq"],
              launches_mesh=mesh_launches["flash_attention_bwd_dq"],
              pipeline=pipeline_at("flash_attention_bwd_dq"),
              **{name: at_shape("flash_attention_bwd_dq", case,
                                bwd_err[("flash_attention_bwd_dq", case)])
                 for name, case in NEW_SHAPES.items() if case in TRAIN_CASES}),
        entry("flash_attention_bwd_dkv", bwd_src,
              "src/repro/kernels/flash_attention.py:258",
              train_launches["flash_attention_bwd_dkv"],
              bwd_err[("flash_attention_bwd_dkv", GPT2B_TRAIN)], GPT2B_TRAIN,
              tol=GRAD_TOL["float32"],
              launches_compile=compile_launches["flash_attention_bwd_dkv"],
              launches_train_moe=moe_train_launches["flash_attention_bwd_dkv"],
              launches_train_hybrid=hybrid_train_launches["flash_attention_bwd_dkv"],
              granite_train=at_shape(
                  "flash_attention_bwd_dkv", GRANITE_TRAIN,
                  bwd_err[("flash_attention_bwd_dkv", GRANITE_TRAIN)]),
              zamba_train=at_shape(
                  "flash_attention_bwd_dkv", ZAMBA_TRAIN,
                  bwd_err[("flash_attention_bwd_dkv", ZAMBA_TRAIN)]),
              launches_audio=audio_serve_launches["flash_attention_bwd_dkv"],
              launches_train_audio=audio_train_launches["flash_attention_bwd_dkv"],
              launches_vlm=vlm_serve_launches["flash_attention_bwd_dkv"],
              launches_pipeline=pipe_launches["flash_attention_bwd_dkv"],
              launches_mesh=mesh_launches["flash_attention_bwd_dkv"],
              pipeline=pipeline_at("flash_attention_bwd_dkv"),
              **{name: at_shape("flash_attention_bwd_dkv", case,
                                bwd_err[("flash_attention_bwd_dkv", case)])
                 for name, case in NEW_SHAPES.items() if case in TRAIN_CASES}),
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
         "launches_cli": cli_launches["ssd_intra"],
         "launches_mesh": mesh_launches["ssd_intra"],
         "train_shape": list(MAMBA_TRAIN[:6]),
         "train_ms": ssd_rows[MAMBA_TRAIN]["ms"],
         "train_bound_ms": ssd_rows[MAMBA_TRAIN]["bound_ms"],
         "train_bound_simt_ms": ssd_rows[MAMBA_TRAIN]["bound_simt_ms"],
         "train_plain_ms": ssd_rows[MAMBA_TRAIN]["plain_ms"],
         "train_max_abs_err": ssd_err[MAMBA_TRAIN],
         "launches_hybrid": hybrid_serve_launches["ssd_intra"],
         "launches_train_hybrid": hybrid_train_launches["ssd_intra"],
         "zamba_prefill": ssd_at(ZAMBA_SSD_PREFILL),
         "zamba_train": ssd_at(ZAMBA_SSD_TRAIN)},
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
                           "train_ssm": ssm_train_launches["rmsnorm"],
                           "main_moe": moe_serve_launches["rmsnorm"],
                           "train_moe": moe_train_launches["rmsnorm"],
                           "main_hybrid": hybrid_serve_launches["rmsnorm"],
                           "train_hybrid": hybrid_train_launches["rmsnorm"],
                           "main_audio": audio_serve_launches["rmsnorm"],
                           "train_audio": audio_train_launches["rmsnorm"],
                           "main_vlm": vlm_serve_launches["rmsnorm"],
                           "pipeline": pipe_launches["rmsnorm"],
                           "compile": compile_launches["rmsnorm"],
                           "mesh": mesh_launches["rmsnorm"]},
         "launches_cli": cli_launches["rmsnorm"],
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
