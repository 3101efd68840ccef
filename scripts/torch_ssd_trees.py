#!/usr/bin/env python3
"""The SSD intra-chunk kernel (K5) timed for one checkout.

Times ``ssd_intra`` (``kernels/ssd_scan.py``) of the checkout at
mamba2-2.7b's prefill (8, 2, 256, 80, 64, 128) and training (8, 4, 256, 80,
64, 128) shapes, in the model's strided layout (x, B and C views of one
fused xBC tensor, as ``ssd_chunked`` hands them over), beside the plain
version on the same inputs and the card's bound (``chip_smoke.ssd_bound``):

  python3 scripts/torch_ssd_trees.py [--root TREE] [--label NAME]

``--root`` is a checkout of the repository whose ``src/repro_torch`` is
timed (default: this one), so that two commits compare in one run on one
card: run parent, change, change, parent (each run is its own process, and
each checkout builds its kernels into its own ``build/``).  Times are CUDA
events over 20 launches after 3 warmup launches (``chip_smoke.cuda_ms``);
one JSON line per shape.  Needs an H100.
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_intra_oracle

    print(cs.nvidia_smi_line(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for case in (cs.MAMBA_PREFILL, cs.MAMBA_TRAIN):
        inputs = cs.ssd_inputs(case, gen, strided=True)
        ms = cs.cuda_ms(lambda: ssd_scan.ssd_intra(*inputs))
        y = ssd_scan.ssd_intra(*inputs)
        err = (y - ssd_intra_oracle(*inputs)).abs().max().item()
        bound_ms, bound_by, ops = cs.ssd_bound(case)
        print(json.dumps({"tree": args.label, "source": ssd_scan.__file__,
                          "kernel": "ssd_intra", "case": case, "dtype": "float32",
                          "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                          "share_of_bound": bound_ms / ms,
                          "bound_simt_ms": ops / cs.PEAK_FLOPS["float32"] * 1e3,
                          "max_abs_err": err}), flush=True)
        del inputs, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
