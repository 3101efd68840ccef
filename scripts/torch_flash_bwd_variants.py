#!/usr/bin/env python3
"""Flash attention backward kernels (K2 dq, K3 dk/dv): where their time goes.

Builds ``src/repro_torch/csrc/flash_attention_bwd.cu`` as it is and with its
compile-time switches set (``FLASH_BWD_*``, through ``kernels/build.py``),
then times K2 and K3 of each build at gpt-2b's training shape (8, 1024,
1024, 32, 32, 80), causal, f32, in two rounds.  The variants compute wrong
gradients on purpose: they only attribute time.

  base            the source as it is;
  no_out_product  without dQ += dS.K (K2) and dV, dK (K3);
  no_scores       without S and dP (the loop over d runs no step);
  one_product     every 3xTF32 product as its big.big term only;
  rows32, rows128 32 (2 warps) or 128 (8 warps) rows per block, not 64;
  tile16          16-row streamed tiles, not 32.

Times are CUDA events over 20 launches after 3 warmup launches.  Run from
the repository root on a machine with an H100:
``python3 scripts/torch_flash_bwd_variants.py``.
"""
import ctypes
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# name: (-D switches, rows per block or None for bwd_blocks')
VARIANTS = {
    "base": ((), None),
    "no_out_product": (("FLASH_BWD_OUT_PRODUCTS=0",), None),
    "no_scores": (("FLASH_BWD_SCORES=0",), None),
    "one_product": (("FLASH_BWD_COMPENSATION=0",), None),
    "rows32": ((), 32),
    "rows128": (("FLASH_BWD_MAX_WARPS=8",), 128),
    "tile16": (("FLASH_BWD_TILE=16",), None),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    defines = {d for d, _ in VARIANTS.values()}
    with ThreadPoolExecutor(len(defines)) as pool:   # one nvcc per build, at once
        list(pool.map(lambda d: build.build_all((fa.BWD_SOURCE,), d), defines))
    kernels = {d: fa.bind_bwd(ctypes.CDLL(str(build.library_path(fa.BWD_SOURCE, d))))
               for d in defines}
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    case = cs.GPT2B_TRAIN
    q, k, v = cs.qkv(case, "float32", gen)
    do = cs.qkv(case, "float32", gen)[0]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    B, T, H, _ = q.shape
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    for rnd in range(2):
        for name, (d, rows) in VARIANTS.items():
            kw = dict(causal=True, window=0, kernels=kernels[d], block_rows=rows)

            def k2():
                fa._launch_bwd("flash_attention_bwd_dq", q, k, v, out, lse, do,
                               delta, dq, None, None, **kw)

            def k3():
                fa._launch_bwd("flash_attention_bwd_dkv", q, k, v, q, lse, do,
                               delta, None, dk, dv, **kw)
            print(json.dumps({"round": rnd, "variant": name, "defines": list(d),
                              "block_rows": rows or fa.bwd_blocks(case[5])[0],
                              "k2_ms": cs.cuda_ms(k2), "k3_ms": cs.cuda_ms(k3)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
