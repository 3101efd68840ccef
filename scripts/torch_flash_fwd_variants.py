#!/usr/bin/env python3
"""Flash attention forward kernel (K1): where its time goes, and its tiles.

Builds ``src/repro_torch/csrc/flash_attention_fwd.cu`` as it is and with its
compile-time switches set (``FLASH_FWD_*``, through ``kernels/build.py``),
then times K1 of each build at gpt-2b's training (8, 1024, 1024, 32, 32, 80)
and prefill (8, 512, 512, 32, 32, 80) shapes, causal, f32, in two rounds,
beside ``F.scaled_dot_product_attention``.  The variants that take a part
out compute wrong outputs on purpose: they only attribute time.

  base            the source as it is, at the default tiles;
  d_unroll1/2     S's loop over the chunks of d unrolled by 1 or 2, not 4;
  no_scores       without S = Q.K^T (the loop over d runs no step);
  no_pv           without O += P.V;
  one_product     every 3xTF32 product as its big.big term only;
  tiles_BQxBK     the base build at (block_q, block_k) other than the default.

Each variant's error against the plain version is printed beside its time.
Times are CUDA events over 20 launches after 3 warmup launches.  Run from
the repository root on a machine with an H100:
``python3 scripts/torch_flash_fwd_variants.py``.
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
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

# name: (-D switches, (block_q, block_k) or None for default_blocks')
VARIANTS = {
    "base": ((), None),
    "d_unroll1": (("FLASH_FWD_D_UNROLL=1",), None),
    "d_unroll2": (("FLASH_FWD_D_UNROLL=2",), None),
    "no_scores": (("FLASH_FWD_SCORES=0",), None),
    "no_pv": (("FLASH_FWD_PV=0",), None),
    "one_product": (("FLASH_FWD_COMPENSATION=0",), None),
    "tiles_64x32": ((), (64, 32)),
    "tiles_64x128": ((), (64, 128)),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    defines = {d for d, _ in VARIANTS.values()}
    with ThreadPoolExecutor(len(defines)) as pool:   # one nvcc per build, at once
        list(pool.map(lambda d: build.build_all((fa.SOURCE,), d), defines))
    kernels = {}
    for d in defines:
        kernels[d] = fa.bind_fwd(ctypes.CDLL(str(build.library_path(fa.SOURCE, d))))
        res = {n.split("flash_fwd_kernel")[-1]: r
               for n, r in cs.kernel_resources(fa.SOURCE, d).items()}
        print(json.dumps({"defines": list(d), "resources": res}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in (cs.GPT2B_TRAIN, cs.GPT2B_PREFILL):
        q, k, v = cs.qkv(case, "float32", gen)
        ro, _ = flash_attention_ref(q, k, v, causal=True)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = cs.cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        for rnd in range(2):
            for name, (d, blocks) in VARIANTS.items():
                bq, bk = blocks or fa.default_blocks(case[5])

                def k1():
                    return fa.flash_attention_fwd(q, k, v, causal=True, block_q=bq,
                                                  block_k=bk, kernel=kernels[d])
                err = (k1()[0] - ro).abs().max().item()
                print(json.dumps({"round": rnd, "case": case, "variant": name,
                                  "defines": list(d), "blocks": [bq, bk],
                                  "ms": cs.cuda_ms(k1), "sdpa_ms": sdpa,
                                  "max_abs_err": err}), flush=True)
        del q, k, v, ro, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
