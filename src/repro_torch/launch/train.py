"""Training launcher (deprecated shim).

Counterpart of ``repro/launch/train.py``.  This entry point predates the
``repro_torch.api`` facade; it delegates to the same code path as

  PYTHONPATH=src python -m repro_torch train --arch gemma-2b --smoke \\
      --steps 200 --batch 8 --seq 128

and warns once.  ``--smoke`` uses the reduced same-family config;
otherwise the full config is built.  Runs on ``cuda`` unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse

from repro_torch import api
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainerConfig


def main(argv=None) -> None:
    api.warn_deprecated(
        "launch.train",
        "repro_torch.launch.train is deprecated: use `python -m repro_torch "
        "train` (the repro_torch.api facade) instead")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-kind", default="markov",
                    choices=["markov", "zipf", "uniform"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    print(f"[train] {cfg.arch_id}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch}x{args.seq}")

    harp_cfg = api.HarpConfig(
        seq_len=args.seq, global_batch=args.batch,
        trainer=TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                              ckpt_every=args.ckpt_every),
        data=DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch, seed=args.seed,
                        kind=args.data_kind))
    out = api.fit(cfg, harp_cfg, n_microbatches=args.microbatches,
                  seed=args.seed, device=args.device,
                  optimizer=OptimizerConfig(lr=args.lr, warmup_steps=20,
                                            total_steps=args.steps))
    hist = out["history"]
    if hist:
        print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
              f"over {out['final_step']} steps")


if __name__ == "__main__":
    main()
