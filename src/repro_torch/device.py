"""Device resolution and the float32 matmul precision policy.

Entry points run on ``cuda`` unless the caller asks for the CPU; without a
card they raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_float32_precision() -> None:
    """Full-float32 products and convolutions: the reference runs in f32,
    and TF32 keeps only about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    set_float32_precision()
    return dev


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator on ``device`` (CUDA generators draw on the card)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


__all__ = ["DeviceLike", "generator", "resolve_device", "set_float32_precision"]
