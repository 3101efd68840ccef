"""How evenly the port's sharded steps split their FLOPs, per family.

For reduced configs widened so every sharded dim divides the 16-way mesh
dims (16 heads of 16, d_model 256, d_ff 512, vocab 1024, 16 experts; the
SSD chunk at its published size), traces one
dry-run cell on the production single-pod mesh (256 ranks, a ``fake``
process group) and the same cell on a 1 x 1 mesh (the whole step on one
rank), both under ``FakeTensorMode`` through ``repro_torch.launch.dryrun``,
and prints ``ratio = flops_per_device * 256 / whole-step flops``: 1.0 where
every product is split 256 ways, above 1 where work is replicated (heads
that do not divide the ``model`` dim, MoE routing of every token on every
rank).  Host counts: nothing runs on a card.

    PYTHONPATH=src python scripts/torch_dryrun_flops_ratio.py [--nmb 2]
"""
import argparse
import dataclasses
import json
import os

import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh

CELLS = [
    ("minitron-8b", "prefill_32k"), ("minitron-8b", "train_4k"),
    ("granite-moe-1b-a400m", "prefill_32k"), ("granite-moe-1b-a400m", "train_4k"),
    ("mamba2-2.7b", "prefill_32k"), ("zamba2-7b", "prefill_32k"),
    ("llama-3.2-vision-90b", "prefill_32k"), ("whisper-medium", "prefill_32k"),
]


def reduced(arch):
    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(), n_heads=16, n_kv_heads=16,
                              head_dim=16, d_model=256, d_ff=512, vocab_size=1024)
    if full.n_experts:
        cfg = dataclasses.replace(cfg, n_experts=16)
    if full.ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=full.ssm_chunk)
    return cfg


def whole_step_flops(arch, shape, cfg):
    dist.init_process_group("fake", store=D._fake_store(), rank=0, world_size=1)
    real = D.make_production_mesh
    D.make_production_mesh = lambda **kw: make_mesh((1, 1), ("data", "model"),
                                                    device_type="cpu")
    try:
        return D.trace_case(D.build_case(arch, shape, False, cfg=cfg))["flops"]
    finally:
        D.make_production_mesh = real
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nmb", default="2", help="REPRO_NMB for train cells")
    args = ap.parse_args()
    os.environ["REPRO_NMB"] = args.nmb
    for arch, shape in CELLS:
        cfg = reduced(arch)
        rec = D.run_cell(arch, shape, "single", None, cfg=cfg)
        whole = whole_step_flops(arch, shape, cfg)
        print(json.dumps({"arch": cfg.arch_id, "shape": shape, "ok": rec["ok"],
                          "flops_per_device": rec.get("flops_per_device"),
                          "whole_step_flops": whole,
                          "ratio": rec["flops_per_device"] * 256 / whole
                          if rec["ok"] else None}), flush=True)


if __name__ == "__main__":
    main()
