"""RMSNorm: the wrapper around the Hopper kernel K4.

``rmsnorm`` launches ``csrc/rmsnorm.cu``, the port of the TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm``.  It takes x (rows, D) through its row
stride and writes y (rows, D) contiguous in x's dtype; the last row tile is
masked, so ``block_rows`` need not divide ``rows``.  A CPU tensor goes
through the plain version (``kernels/ref.py:rmsnorm_ref``); a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm_ref

SOURCE = "rmsnorm.cu"
DEFAULT_BLOCK_ROWS = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load(SOURCE)
        fn = lib.rmsnorm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i64, i32, i64, i32,
                       ctypes.c_float, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(x, w, block_rows):
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, D), got {tuple(x.shape)}")
    if w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"w {tuple(w.shape)}: expected ({x.shape[1]},)")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32 "
                            "or bfloat16")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if block_rows < 1:
        raise ValueError(f"block_rows={block_rows}: must be positive")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """x: (rows, D); w: (D,) -> ``(x * rsqrt(mean(x**2) + eps)) * w`` in
    x's dtype, statistics in float32.  The kernel takes float32 or bfloat16
    for x and for w, any row stride with the last dim contiguous."""
    block_rows = int(block_rows)
    _check(x, w, block_rows)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no RMSNorm kernel for device {x.device}")
    rows, D = x.shape
    y = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0 or D == 0:
        return y
    if x.stride(1) != 1 or w.stride(0) != 1:
        raise ValueError("the last dim of x, and w, must be contiguous")
    row_stride = x.stride(0) if rows > 1 else D
    lib, fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[w.dtype], rows, D, row_stride, block_rows, eps,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, lib, "rmsnorm")
    LAUNCHES["rmsnorm"] += 1
    return y
