#!/usr/bin/env python3
"""SSD intra-chunk kernel (K5): where its time goes.

Builds ``src/repro_torch/csrc/ssd_intra.cu`` as it is and with its
compile-time switches set (``SSD_*``, through ``kernels/build.py``), then
times K5 of each build at mamba2-2.7b's training (8, 4, 256, 80, 64, 128)
and prefill (8, 2, 256, 80, 64, 128) shapes in the model's strided layout,
f32, in two rounds.  The variants that take a part out compute wrong
outputs on purpose: they only attribute time.

  base            the source as it is;
  no_cb           without the C.B^T products (phase 1 runs no step);
  no_mx           without M x (phase 2 builds no M and runs no product);
  one_product     every 3xTF32 product as its big.big term only.

Each variant's error against the plain version is printed beside its time,
and each build's registers, stack and local memory (``cuobjdump``).  Times
are CUDA events over 20 launches after 3 warmup launches.  Run from the
repository root on a machine with an H100:
``python3 scripts/torch_ssd_variants.py``.
"""
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
from repro_torch.kernels import ssd_scan  # noqa: E402
from repro_torch.kernels.ref import ssd_intra_oracle  # noqa: E402

VARIANTS = {   # name: -D switches
    "base": (),
    "no_cb": ("SSD_CB=0",),
    "no_mx": ("SSD_MX=0",),
    "one_product": ("SSD_COMPENSATION=0",),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    defines = list(VARIANTS.values())
    with ThreadPoolExecutor(len(defines)) as pool:   # one nvcc per build, at once
        for f in [pool.submit(build.build_all, (ssd_scan.SOURCE,), d) for d in defines]:
            f.result()
    kernels = {}
    for name, d in VARIANTS.items():
        kernels[name] = ssd_scan.bind(
            build.ctypes.CDLL(str(build.library_path(ssd_scan.SOURCE, d))))
        res = {n.split("ssd_intra_kernel")[-1]: r
               for n, r in cs.kernel_resources(ssd_scan.SOURCE, d).items()}
        print(json.dumps({"variant": name, "defines": list(d), "resources": res}),
              flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in (cs.MAMBA_TRAIN, cs.MAMBA_PREFILL):
        inputs = cs.ssd_inputs(case, gen, strided=True)
        ref = ssd_intra_oracle(*inputs)
        bound_ms = cs.ssd_bound(case)[0]
        for rnd in range(2):
            for name, d in VARIANTS.items():
                def k5():
                    return ssd_scan.ssd_intra(*inputs, kernel=kernels[name])
                err = (k5() - ref).abs().max().item()
                ms = cs.cuda_ms(k5)
                print(json.dumps({"round": rnd, "case": case, "variant": name,
                                  "defines": list(d), "ms": ms,
                                  "share_of_bound": bound_ms / ms,
                                  "max_abs_err": err}), flush=True)
        del inputs, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
