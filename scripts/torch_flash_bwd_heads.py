#!/usr/bin/env python3
"""Flash attention backward kernels (K2 dq, K3 dk/dv) timed across head dims.

Times ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` through the
port's wrappers, f32, causal, at gpt-2b's training shape (D = 80), at the
wide-head cases of ``chip_smoke.py`` (gemma-2b's MQA D = 256, zamba2's D =
112) and at those two models' full-width training shapes (8 x 1024):

  python3 scripts/torch_flash_bwd_heads.py [--root TREE] [--label NAME]

``--root`` is a checkout of the repository whose ``src/repro_torch`` is
timed (default: this one), so that two commits compare in one run on one
card.  Each checkout builds its kernels into its own ``build/``.  Times are
CUDA events over 20 launches after 3 warmup launches; one JSON line per case.
Needs an H100.
"""
import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = [   # (B, Tq, Tk, H, KV, D, causal, window)
    (8, 1024, 1024, 32, 32, 80, True, 0),     # gpt-2b training
    (2, 512, 512, 8, 1, 256, True, 0),        # gemma-2b, chip_smoke's case
    (8, 1024, 1024, 8, 1, 256, True, 0),      # gemma-2b training
    (2, 300, 300, 4, 4, 112, True, 0),        # zamba2, chip_smoke's case
    (8, 1024, 1024, 32, 32, 112, True, 0),    # zamba2 training
]


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
    from repro_torch.kernels import flash_attention as fa

    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in CASES:
        kw = dict(causal=case[6], window=case[7])
        q, k, v = cs.qkv(case, "float32", gen)
        do = cs.qkv(case, "float32", gen)[0]
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        _, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
        k2 = cs.cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, out, lse, do, **kw))
        k3 = cs.cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw))
        print(json.dumps({"tree": args.label, "source": fa.__file__, "case": case,
                          "k2_ms": k2, "k3_ms": k3, "k2_plus_k3_ms": k2 + k3}),
              flush=True)
        del q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
