#!/usr/bin/env python3
"""Flash attention forward (K1) and RMSNorm (K4) timed for one checkout.

Times ``flash_attention_fwd`` at gpt-2b's prefill (8, 512, 512, 32, 32, 80)
and training (8, 1024, 1024, 32, 32, 80) shapes, causal, in f32 and bf16,
and K1 at the wide heads of ``chip_smoke.py`` (gemma-2b's D = 256, zamba2's
D = 112), and ``rmsnorm`` at the full-width hidden states (4096, 2560) and
(8192, 2560) in f32, through the port's wrappers at their default blocks,
beside ``F.scaled_dot_product_attention`` and ``F.rms_norm``:

  python3 scripts/torch_fwd_rmsnorm_trees.py [--root TREE] [--label NAME]

``--root`` is a checkout of the repository whose ``src/repro_torch`` is
timed (default: this one), so that two commits compare in one run on one
card: run parent, change, change, parent.  Each checkout builds its kernels
into its own ``build/``.  Times are CUDA events over 20 launches after 3
warmup launches (``chip_smoke.cuda_ms``); one JSON line per case.  Needs an
H100.
"""
import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLASH_CASES = [   # (B, Tq, Tk, H, KV, D, causal, window), dtype
    ((8, 512, 512, 32, 32, 80, True, 0), "float32"),      # gpt-2b prefill
    ((8, 1024, 1024, 32, 32, 80, True, 0), "float32"),    # gpt-2b training
    ((8, 512, 512, 32, 32, 80, True, 0), "bfloat16"),
    ((8, 1024, 1024, 32, 32, 80, True, 0), "bfloat16"),
    ((2, 512, 512, 8, 1, 256, True, 0), "float32"),       # gemma-2b
    ((2, 300, 300, 4, 4, 112, True, 0), "float32"),       # zamba2
]
RMS_SHAPES = [(4096, 2560), (8192, 2560)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case, dtype in FLASH_CASES:
        kw = dict(causal=case[6], window=case[7])
        q, k, v = cs.qkv(case, dtype, gen)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ms = cs.cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        sdpa = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"]))
        print(json.dumps({"tree": args.label, "source": fa.__file__,
                          "kernel": "flash_attention_fwd", "case": case,
                          "dtype": dtype, "ms": ms, "sdpa_ms": sdpa}), flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for shape in RMS_SHAPES:
        x, w = cs.rms_inputs(shape, "float32", gen)
        ms = cs.cuda_ms(lambda: rn.rmsnorm(x, w))
        lib = cs.cuda_ms(lambda: F.rms_norm(x, (shape[-1],), w, 1e-6))
        print(json.dumps({"tree": args.label, "source": rn.__file__,
                          "kernel": "rmsnorm", "case": shape, "dtype": "float32",
                          "ms": ms, "f_rms_norm_ms": lib}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
