"""The Mamba-2 SSD intra-chunk term: the wrapper around the Hopper kernel K5.

``ssd_intra`` launches ``csrc/ssd_intra.cu``, the port of the TPU kernel
``repro/kernels/ssd_scan.py:ssd_intra``.  It takes the model layout, which
the kernel reads through strides: ``ssd_chunked``'s chunked views of x, B
and C are slices of one fused projection, so nothing is copied or
transposed.  A CPU tensor goes through the plain version
(``kernels/ref.py:ssd_intra_oracle``); a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_intra_oracle

SOURCE = "ssd_intra.cu"
MAX_CHUNK = 256      # kMaxQ in the source
MAX_HEAD_DIM = 128   # kMaxP
MAX_STATE = 128      # kMaxN
STRIP = 16           # kStrip: query rows of a warp (the m16 of the mma)
KEY_TILE = 32        # kBJ: keys per tile of B (phase 1) and of x (phase 2)
GROUP_ROWS = 64      # kGroupRows: rows of C staged at once in phase 1
X_STRIDE = 68        # kXs: shared row stride of a tile of 64 columns of x
RING_STAGES = 4      # kStages: buffers of the x ring
SPLIT_STRIDE = 264   # kSplitStride: a row pair of the split tile, 2 x (big, small) per column

_fn = None


def _stride_8_mod_32(n: int) -> int:
    return n + (8 - n % 32) % 32


def ssd_shared_bytes(chunk: int, state: int) -> int:
    """Dynamic shared memory of one block of K5 at chunk Q and state N (the
    head dim does not change it): each 16-row strip s of C.B^T up to its
    last key, 16 (s + 1) keys at a row stride of 8 mod 32 floats, then the
    larger of phase 1's 64 rows of C and two 32-key tiles of B (N rounded up
    to 8, stride 8 mod 32) and phase 2's x ring (4 buffers of 32 keys of 64
    columns at a stride of 68 floats, and (cum, dt) per key) with two split
    tiles (16 row pairs of 64 columns of two (big, small) pairs, at a stride
    of 264 floats).  The kernel's own formula (``ssd_intra_shared_bytes``)
    is held equal to it on the card."""
    strips = -(-chunk // STRIP)
    cb = STRIP * sum(32 * (s // 2) + 40 for s in range(strips))
    phase1 = (GROUP_ROWS + 2 * KEY_TILE) * _stride_8_mod_32(-(-state // 8) * 8)
    phase2 = (RING_STAGES * (KEY_TILE * X_STRIDE + 2 * KEY_TILE)
              + 2 * KEY_TILE // 2 * SPLIT_STRIDE)
    return 4 * (cb + max(phase1, phase2))


def bind(lib: ctypes.CDLL):
    """(lib, launch, shared bytes) of a built K5 library."""
    fn = lib.ssd_intra
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([ptr] * 6 + [i32] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), ptr])
    fn.restype = i32
    size = lib.ssd_intra_shared_bytes
    size.argtypes = [i32] * 2
    size.restype = ctypes.c_longlong
    return lib, fn, size


def _kernel():
    global _fn
    if _fn is None:
        _fn = bind(build.load(SOURCE))
    return _fn


def ssd_kernel_shared_bytes(chunk: int, state: int) -> int:
    """The kernel's own size of a block (builds it), which
    :func:`ssd_shared_bytes` must equal."""
    return int(_kernel()[2](chunk, state))


def _check(xc, dtc, cum, Bc, Cc):
    if xc.dim() != 5:
        raise ValueError(f"xc must be (B, nc, Q, H, P), got {tuple(xc.shape)}")
    Bsz, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    for name, t, shape in (("dtc", dtc, (Bsz, nc, Q, H)), ("cum", cum, (Bsz, nc, Q, H)),
                           ("Bc", Bc, (Bsz, nc, Q, N)), ("Cc", Cc, (Bsz, nc, Q, N))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)}: expected {shape}")
    for name, t in (("xc", xc), ("dtc", dtc), ("cum", cum), ("Bc", Bc), ("Cc", Cc)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
        if t.device != xc.device:
            raise ValueError("xc, dtc, cum, Bc and Cc must be on one device")


def ssd_intra(xc: torch.Tensor, dtc: torch.Tensor, cum: torch.Tensor,
              Bc: torch.Tensor, Cc: torch.Tensor, *, kernel=None) -> torch.Tensor:
    """Intra-chunk SSD term, float32 throughout.

    xc: (B, nc, Q, H, P); dtc, cum: (B, nc, Q, H); Bc, Cc: (B, nc, Q, N).
    Returns y (B, nc, Q, H, P), contiguous:
    ``y[q] = sum_{j<=q} (C_q . B_j) * exp(cum_q - cum_j) * dt_j * x_j``.
    The kernel takes Q <= 256, P <= 128 and N <= 128, any strides with the
    last dim of xc, Bc and Cc contiguous.  ``kernel`` (from :func:`bind`)
    stands in for the built library in scripts that time builds of the
    source with other switches."""
    _check(xc, dtc, cum, Bc, Cc)
    if xc.device.type == "cpu":
        return ssd_intra_oracle(xc, dtc, cum, Bc, Cc)
    if xc.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {xc.device}")
    Bsz, nc, Q, H, P = xc.shape
    N = Bc.shape[-1]
    if not (1 <= Q <= MAX_CHUNK and 1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE):
        raise ValueError(f"Q={Q}, P={P}, N={N}: the kernel takes Q <= "
                         f"{MAX_CHUNK}, P <= {MAX_HEAD_DIM}, N <= {MAX_STATE}")
    if xc.stride(-1) != 1 or Bc.stride(-1) != 1 or Cc.stride(-1) != 1:
        raise ValueError("the last dim of xc, Bc and Cc must be contiguous")
    y = torch.empty((Bsz, nc, Q, H, P), dtype=torch.float32, device=xc.device)
    strides = (ctypes.c_longlong * 18)(
        *xc.stride()[:4], *dtc.stride(), *cum.stride(), *Bc.stride()[:3],
        *Cc.stride()[:3])
    lib, fn, _ = kernel or _kernel()
    with torch.cuda.device(xc.device):
        err = fn(xc.data_ptr(), dtc.data_ptr(), cum.data_ptr(), Bc.data_ptr(),
                 Cc.data_ptr(), y.data_ptr(), Bsz, nc, Q, H, P, N, strides,
                 torch.cuda.current_stream().cuda_stream)
    build.check(err, lib, "ssd_intra")
    LAUNCHES["ssd_intra"] += 1
    return y
