#!/usr/bin/env python3
"""The H100's kbench anchor (measured MFU) and the planner's split, for one
checkout.

Runs kbench on the card as ``chip_smoke.py``'s ``kbench`` phase builds its
table (``collect(shapes="default")``, ``collect_autotuned`` with its winners
installed, flash swept and installed at gpt-2b's D = 80 shape, the main
paths' full-width shapes at the blocks the entry points resolve to), then
``chip_smoke.run_plan`` on that table: the HAPT planner on an H100 mesh in
front of the paper's A100 and V100 meshes, gpt-2b and mamba2-2.7b, with
each mesh's measured MFU and layers per stage on its ``plan`` lines:

  python3 scripts/torch_kbench_anchor.py [--root TREE] [--label NAME] [--per-call]

``--root`` is a checkout whose ``src/repro_torch`` is measured (default:
this one), so that two commits compare in one run on one card.
``--per-call`` times each trial as one call between its own pair of CUDA
events (kbench's timing before its trials ran back to back), so that the
timing's share of the anchor and the kernels' share separate.  Needs an H100.
"""
import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--per-call", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import chip_smoke as cs
    from repro_torch.device import set_float32_precision
    from repro_torch.kbench import autotune, harness
    from repro_torch.kernels import ops

    set_float32_precision()
    if args.per_call:
        harness.calls_per_trial = lambda fn, *a, **k: 1
    print(cs.nvidia_smi_line(), flush=True)
    trials, warmup = 20, 3
    fp = harness.device_fingerprint()
    table = harness.collect(shapes="default", trials=trials, warmup=warmup)
    tuned, _ = autotune.collect_autotuned(shapes="default", trials=trials,
                                          warmup=warmup)
    autotune.install(tuned)
    tuned = tuned.merge(cs.sweep_flash_main_shape(trials, warmup)[0])
    for op, shape in sorted(cs.KBENCH_FULL.items()):
        blocks = (ops.tuned_blocks(op, shape)
                  or harness.OPS[op].default_blocks(shape))
        table.add(harness.measurement(harness.bench_op(
            op, shape, blocks=blocks, trials=trials, warmup=warmup)))
    ops.clear_tuned_blocks()
    table = table.merge(tuned)
    print(json.dumps({"tree": args.label, "source": harness.__file__,
                      "per_call": args.per_call,
                      "cells": [{"op": e.op, "shape": list(e.shape),
                                 "blocks": e.blocks, "median_s": e.median_s,
                                 "tflops": e.flops / e.median_s / 1e12}
                                for e in table.entries]}), flush=True)
    cs.run_plan(table, fp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
