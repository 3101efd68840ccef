"""Flash attention: wrappers around the Hopper kernels and the autograd
function that joins them.

- ``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu``, the port
  of the TPU kernel ``repro/kernels/flash_attention.py:_fwd_kernel``;
- ``flash_attention_bwd`` launches the two kernels of
  ``csrc/flash_attention_bwd.cu``, the ports of ``_dq_kernel`` and
  ``_dkv_kernel``;
- :class:`FlashAttention` is the counterpart of the reference's
  ``custom_vjp`` (``repro/kernels/ops.py:_flash``): forward through the
  first, backward through the second.

The wrappers take the model layout (q (B, T, H, D); k, v (B, S, KV, D)),
which the kernels read through strides, so nothing is transposed or padded.
A CPU tensor goes through the plain versions (``kernels/ref.py``); a CUDA
tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref, flash_attention_ref,
)

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
MAX_HEAD_DIM = 256
MAX_SHARED_BYTES = 232448   # a block's dynamic shared memory on an H100
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
_bwd_fns = None

# The forward kernel (csrc/flash_attention_fwd.cu): a warp owns a 16-row
# strip (the m16 of the tensor cores' mma), a block up to 4 strips; K and V
# come in tiles of block_k keys, double-buffered, consumed in steps of 32.
# Heads past 80 columns take the wide form, where the 4 warps of a strip
# share D, at most 2 strips a block.  ``fwd_shared_bytes`` is the kernel's
# own size of a block (``flash_attention_fwd_shared_bytes``), held equal on
# the card.
ROWS_PER_WARP = 16    # kStrip in the source
MAX_BLOCK_Q = 64      # kStrip * kMaxStrips
MAX_WIDE_BLOCK_Q = 32 # kStrip * kMaxWideStrips
KEY_STEP = 32         # kStep: block_k is a multiple of it
FWD_MAX_WIDTH = 10    # kMaxWidth: chunks of 8 columns per warp
FWD_OVERRUN = 64      # kOverrun: elements read past the last staged row


def fwd_wide(head_dim: int) -> bool:
    """Whether the forward kernel takes its wide form (D > 80)."""
    return -(-head_dim // 8) > FWD_MAX_WIDTH


def _row_stride_words(head_dim: int, elem: int) -> int:
    """A staged row in 4-byte words: D padded to a multiple of 8 elements
    and to 4 mod 8 words."""
    words = -(-head_dim // 8) * 8 * elem // 4
    return words if words % 8 == 4 else words + 4


def fwd_shared_bytes(head_dim: int, block_q: int, block_k: int,
                     elem: int = 4) -> int:
    """Dynamic shared memory of a forward block: block_q rows of q, two
    buffers of block_k rows of k and of v, room for reads past the last
    row, and for wide heads each of the 2 strips' f32 P buffer (16 x 40)
    with its row maxima and sums (16 x 4 each)."""
    n = (4 * _row_stride_words(head_dim, elem) * (block_q + 4 * block_k)
         + FWD_OVERRUN * elem)
    if fwd_wide(head_dim):
        n += 4 * MAX_WIDE_BLOCK_Q * (KEY_STEP + 8 + 8)
    return n


def fits_shared_memory(head_dim: int, block_q: int, block_k: int,
                       elem: int = 4) -> bool:
    """Whether a forward block at these tiles fits a block's 227 KB of
    shared memory (``elem``: bytes per element, 4 for f32, 2 for bf16)."""
    return fwd_shared_bytes(head_dim, block_q, block_k, elem) <= MAX_SHARED_BYTES


def tile_rule(head_dim: int, block_q: int, block_k: int) -> Optional[str]:
    """Why the forward kernel refuses (block_q, block_k) at this head dim by
    its block rules, or None where it takes them."""
    top = MAX_WIDE_BLOCK_Q if fwd_wide(head_dim) else MAX_BLOCK_Q
    if block_q % ROWS_PER_WARP or not ROWS_PER_WARP <= block_q <= top:
        return (f"block_q={block_q}: a multiple of {ROWS_PER_WARP} up to "
                f"{top} at head dim {head_dim}")
    if block_k % KEY_STEP or block_k < KEY_STEP:
        return f"block_k={block_k}: a positive multiple of {KEY_STEP}"
    return None


def tile_fits(head_dim: int, block_q: int, block_k: int, elem: int = 4) -> bool:
    """Whether the forward kernel launches at these tiles: its block rules
    and shared memory."""
    return (tile_rule(head_dim, block_q, block_k) is None
            and fits_shared_memory(head_dim, block_q, block_k, elem))


def default_blocks(head_dim: int) -> Tuple[int, int]:
    """(block_q, block_k) when nothing is tuned: 64 query rows (4 strips)
    and 64 keys; for wide heads (D > 80) 32 rows (2 strips) and 32 keys,
    whose f32 tiles fit shared memory up to D = 256."""
    return (32, 32) if fwd_wide(head_dim) else (64, 64)


# The backward kernels (csrc/flash_attention_bwd.cu): a warp owns a 16-row
# strip (the m16 of the tensor cores' mma) and up to 10 chunks of 8 columns
# of D, at most 4 warps a block; wider heads take the wide kernels, where the
# 4 warps of a strip share D, at most 2 strips a block.  The streamed side
# comes in tiles of 32 rows, double-buffered.  The block's rows are chosen
# here; the kernels' own size of a block (``flash_attention_bwd_shared_bytes``)
# is held equal to bwd_shared_bytes on the card.
BWD_ROWS_PER_WARP = 16    # kStrip in the source
BWD_MAX_BLOCK_ROWS = 64   # kStrip * kMaxWarps
BWD_MAX_WIDE_ROWS = 32    # kStrip * kMaxWideStrips
BWD_MAX_WIDTH = 10        # kMaxWidth: chunks of 8 columns per warp
BWD_TILE = 32             # kTile
BWD_OVERRUN = 64          # kOverrun: elements read past the last staged row
SM_SHARED_BYTES = 233472  # an H100 SM's shared memory (228 KB), 1 KB per block reserved


def bwd_wide(head_dim: int) -> bool:
    """Whether the backward kernels take their wide form (D > 80)."""
    return -(-head_dim // 8) > BWD_MAX_WIDTH


def bwd_shared_bytes(head_dim: int, block_rows: int, elem: int = 4,
                     dkv: bool = True) -> int:
    """Dynamic shared memory of the dk/dv kernel (``dkv``) or the dq kernel:
    block_rows stationary rows of two tensors, two buffers of BWD_TILE rows
    of two tensors, for dk/dv their lse and delta, for wide heads each
    strip's f32 P / dS buffer (dk/dv: both) of BWD_TILE + 8 columns, and
    room for reads past the last row; rows of D padded to a multiple of 8
    elements and to a stride of 4 mod 8 words."""
    words = -(-head_dim // 8) * 8 * elem // 4
    ks = words if words % 8 == 4 else words + 4
    n = (4 * ks * (2 * block_rows + 4 * BWD_TILE) + BWD_OVERRUN * elem
         + (16 * BWD_TILE if dkv else 0))
    if bwd_wide(head_dim):
        n += 4 * block_rows * (BWD_TILE + 8) * (2 if dkv else 1)
    return n


def bwd_blocks(head_dim: int) -> Tuple[int, int]:
    """(block_rows, block_tile) of the backward kernels: the most rows (64,
    or 32 for wide heads) whose f32 tiles fit a block's shared memory, else
    fewer; always 32-row tiles."""
    top = BWD_MAX_WIDE_ROWS if bwd_wide(head_dim) else BWD_MAX_BLOCK_ROWS
    for rows in range(top, 0, -BWD_ROWS_PER_WARP):
        if bwd_shared_bytes(head_dim, rows) <= MAX_SHARED_BYTES:
            return rows, BWD_TILE
    raise ValueError(f"head dim {head_dim}: no backward block fits shared memory")


def bind_fwd(lib: ctypes.CDLL):
    """(lib, launch, shared bytes) of a built forward library."""
    fn = lib.flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 5 + [i32] * 7 + [i64] * 9
                   + [ctypes.c_float] + [i32] * 4 + [ptr])
    fn.restype = i32
    size = lib.flash_attention_fwd_shared_bytes
    size.argtypes = [i32] * 4
    size.restype = i64
    return lib, fn, size


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind_fwd(build.load(SOURCE))
    return _fn


def fwd_kernel_shared_bytes(head_dim: int, block_q: int, block_k: int,
                            elem: int = 4) -> int:
    """The forward kernel's own size of a block (builds it), which
    :func:`fwd_shared_bytes` must equal."""
    return int(_kernel()[2](0 if elem == 4 else 1, head_dim, block_q, block_k))


def _check_qkv(q, k, v):
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


def _check(q, k, v, block_q, block_k):
    _check_qkv(q, k, v)
    why = tile_rule(q.shape[-1], block_q, block_k)
    if why:
        raise ValueError(why)
    D, elem = q.shape[-1], q.element_size()
    need = fwd_shared_bytes(D, block_q, block_k, elem)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"tiles ({block_q}, {block_k}) at head dim {D}, "
                         f"{elem}-byte elements need {need} bytes of shared "
                         f"memory; a block has {MAX_SHARED_BYTES}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None, kernel=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, T, H, D); k, v (B, S, KV, D) -> (out (B, T, H, D), lse (B, H, T)).

    Same contract as the TPU kernel: scale ``D**-0.5``, causal ``k <= q``,
    window ``k > q - window``, GQA kv head ``h // (H // KV)``, out in q's
    dtype, float32 lse, zero out and ``-inf`` lse on fully masked rows.
    ``kernel`` (from :func:`bind_fwd`) stands in for the built library in
    scripts that time builds of the source with other switches."""
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
    lib, fn, _ = kernel or _kernel()
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


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def bind_bwd(lib: ctypes.CDLL):
    """(lib, {entry point: function}) of a built backward library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * 10 + [i32] * 7
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [i32] * 3 + [ptr])
        fn.restype = i32
        fns[name] = fn
    fn = lib.flash_attention_bwd_shared_bytes
    fn.argtypes = [i32] * 4
    fn.restype = ctypes.c_longlong
    fns["shared_bytes"] = fn
    return lib, fns


def _bwd_kernels():
    global _bwd_fns
    if _bwd_fns is None:
        _bwd_fns = bind_bwd(build.load(BWD_SOURCE))
    return _bwd_fns


def bwd_kernel_shared_bytes(head_dim: int, block_rows: int, elem: int = 4,
                            dkv: bool = True) -> int:
    """The backward kernels' own size of a block (builds them), which
    :func:`bwd_shared_bytes` must equal."""
    return int(_bwd_kernels()[1]["shared_bytes"](
        int(dkv), 0 if elem == 4 else 1, head_dim, block_rows))


def _check_bwd(q, k, v, out, lse, do):
    _check_qkv(q, k, v)
    B, T, H, _ = q.shape
    for name, x in (("out", out), ("do", do)):
        if x is not None and (x.shape != q.shape or x.dtype != q.dtype):
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} must match q "
                             f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: expected "
                         f"({B}, {H}, {T}) float32")
    if any(x is not None and x.device != q.device for x in (out, lse, do)):
        raise ValueError("q, out, do and lse must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention kernel for device {q.device}")


def _launch_bwd(name, q, k, v, out, lse, do, delta, dq, dk, dv, causal,
                window, kernels=None, block_rows=None) -> None:
    """Both kernels run with :func:`bwd_blocks`: block_rows rows owned by a
    block's warps (queries for dq, keys for dk/dv), 32 rows of the other
    side streamed per step.  ``kernels`` (from :func:`bind_bwd`) and
    ``block_rows`` stand in for the built library and the block's rows in
    scripts that time builds of the source with other switches."""
    if any(x.stride(-1) != 1 for x in (q, k, v, out, do)):
        raise ValueError("the head dim of q, k, v, out and do must be contiguous")
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    block_rows = block_rows or bwd_blocks(D)[0]
    strides = (ctypes.c_longlong * 15)(*(
        s for x in (q, k, v, out, do) for s in x.stride()[:3]))
    lib, fns = kernels or _bwd_kernels()
    with torch.cuda.device(q.device):
        err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(),
                        *(0 if x is None else x.data_ptr() for x in (dq, dk, dv)),
                        _DTYPE_CODE[q.dtype], B, T, S, H, KV, D, strides,
                        D ** -0.5, int(causal), int(window), block_rows,
                        torch.cuda.current_stream().cuda_stream)
    build.check(err, lib, name)
    LAUNCHES[name] += 1


def _dense_last(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()   # e.g. an expanded grad


def flash_attention_bwd_dq(q, k, v, out, lse, do, *, causal: bool,
                           window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dq kernel: (dq (B, T, H, D) in q's dtype, delta (B, H, T) f32),
    ``delta = rowsum(do * out)``, which the dk/dv kernel reads."""
    _check_bwd(q, k, v, out, lse, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, out, lse, do, causal=causal,
                                          window=window)
    do = _dense_last(do)
    B, T, H, D = q.shape
    dq = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    _launch_bwd("flash_attention_bwd_dq", q, k, v, out, lse.contiguous(), do,
                delta, dq, None, None, causal, window)
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, lse, do, delta, *, causal: bool,
                            window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel: (dk, dv) (B, S, KV, D) in k's and v's dtypes,
    summed over the query heads of each kv head; ``delta`` is the dq
    kernel's."""
    _check_bwd(q, k, v, None, lse, do)
    if delta.shape != lse.shape or delta.dtype != torch.float32:
        raise ValueError(f"delta {tuple(delta.shape)} {delta.dtype}: expected "
                         f"{tuple(lse.shape)} float32")
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, lse, do, delta,
                                           causal=causal, window=window)
    do = _dense_last(do)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    # the dk/dv kernel reads no out: pass q for its (unused) pointer/strides
    _launch_bwd("flash_attention_bwd_dkv", q, k, v, q, lse.contiguous(), do,
                delta.contiguous(), None, dk, dv, causal, window)
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of :func:`flash_attention_fwd`: (dq, dk, dv) in the layouts
    and dtypes of q, k, v, with dk and dv summed over each GQA group.

    ``out`` and ``lse`` are the forward's; ``do`` is the gradient of
    ``out``.  Launches the dq kernel, then the dk/dv kernel (on a CPU tensor:
    their plain versions)."""
    kw = dict(causal=causal, window=window)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, **kw)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    ``custom_vjp`` (``repro/kernels/ops.py:_flash``).  The forward saves q,
    k, v, out and lse; the backward is :func:`flash_attention_bwd`, so on
    the CPU it is the plain K2/K3 contract, not autograd through the plain
    forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, block_q: Optional[int],
                block_k: Optional[int]):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None
