"""Serving launcher: prefill a batch of prompts, then batched decode.

Counterpart of ``repro/launch/serve.py``: a thin CLI over
:func:`repro_torch.api.generate` (greedy argmax by default; ``--sample
--temperature T`` threads a generator through the serve step), deprecated
in favour of calling it directly.  Runs on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --smoke \\
      --batch 4 --prompt-len 32 --gen 32
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true",
                    help="temperature sampling instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from repro_torch import api

    api.warn_deprecated(
        "launch.serve",
        "repro_torch.launch.serve is deprecated: call "
        "repro_torch.api.generate() directly (same prefill + batched-decode "
        "path, one facade)")
    out = api.generate(
        args.arch, batch=args.batch, prompt_len=args.prompt_len,
        gen_tokens=args.gen, seed=args.seed, greedy=not args.sample,
        temperature=args.temperature, reduced=args.smoke, log_fn=print,
        device=args.device)
    print(f"[serve] sample: {out['tokens'][0, :16].tolist()}")


if __name__ == "__main__":
    main()
