"""Flash attention forward: wrapper around the Hopper kernel
``csrc/flash_attention_fwd.cu``, the port of the TPU kernel
``repro/kernels/flash_attention.py:_fwd_kernel``.

The wrapper takes the model layout (q (B, T, H, D); k, v (B, S, KV, D)),
which the kernel reads through strides, so nothing is transposed or padded.
A CPU tensor goes through the plain version (``ref.flash_attention_ref``);
a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = "flash_attention_fwd.cu"
MAX_HEAD_DIM = 256
ROWS_PER_WARP = 4     # kRows in the source
MAX_BLOCK_Q = 64      # kRows * kMaxWarps in the source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def default_blocks(head_dim: int) -> Tuple[int, int]:
    """(block_q, block_k) when nothing is tuned: 32 query rows (8 warps),
    and 64 keys unless wide heads need the shared memory (D > 128)."""
    return 32, (64 if head_dim <= 128 else 32)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load(SOURCE)
        fn = lib.flash_attention_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 9
                       + [ctypes.c_float] + [i32] * 4 + [ptr])
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(q, k, v, block_q, block_k):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention_fwd takes 4-d q (B,T,H,D) and "
                         "k, v (B,S,KV,D)")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                        "takes float32 or bfloat16, all alike")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if block_q % ROWS_PER_WARP or not ROWS_PER_WARP <= block_q <= MAX_BLOCK_Q:
        raise ValueError(f"block_q={block_q}: a multiple of {ROWS_PER_WARP} "
                         f"up to {MAX_BLOCK_Q}")
    if block_k % 32 or block_k < 32:
        raise ValueError(f"block_k={block_k}: a positive multiple of 32")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, T, H, D); k, v (B, S, KV, D) -> (out (B, T, H, D), lse (B, H, T)).

    Same contract as the TPU kernel: scale ``D**-0.5``, causal ``k <= q``,
    window ``k > q - window``, GQA kv head ``h // (H // KV)``, out in q's
    dtype, float32 lse, zero out and ``-inf`` lse on fully masked rows."""
    bq, bk = default_blocks(q.shape[-1])
    block_q = bq if block_q is None else int(block_q)
    block_k = bk if block_k is None else int(block_k)
    _check(q, k, v, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")

    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODE[q.dtype], B, T, S, H, KV, D,
                 q.stride(0), q.stride(1), q.stride(2),
                 k.stride(0), k.stride(1), k.stride(2),
                 v.stride(0), v.stride(1), v.stride(2),
                 D ** -0.5, int(causal), int(window), block_q, block_k,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, lib, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out, lse
