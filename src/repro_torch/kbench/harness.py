"""Deterministic microbenchmark harness for the port's kernels.

Counterpart of ``repro/kbench/harness.py``.  Measures the public entry points
in ``kernels/ops.py`` (flash attention K1, SSD intra-chunk K5, rmsnorm K4)
with the reference's numpy-seeded inputs, op names, shape keys and FLOP
formulas: warmup calls, then each timed call bracketed by CUDA events and
synchronised, median of ``trials``.  Tables are stamped ``cuda:<card name>``.
The CPU runs the kernels' plain versions, timed with ``time.perf_counter``,
and only when asked (``run_device="cpu"``); its cells are stamped
``cpu:<machine>:plain`` so that a CPU table is never taken for a card's.

``device`` keeps the reference's meaning in ``measurement`` and ``collect``:
a table fingerprint override.  Where the ops run is ``run_device``, which
defaults to ``cuda`` and raises without a card.

Shape-key conventions (shared with the tuned-block registry in ops.py):

  - ``flash_attention``: (B, T, S, H, KV, D)
  - ``rmsnorm``:         (rows, D)
  - ``ssd_intra``:       (B, nc, Q, H, P, N)
"""
from __future__ import annotations

import platform
import socket
import statistics
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kbench.table import KernelMeasurement, LatencyTable


# ---------------------------------------------------------------------------
# Op registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpSpec:
    name: str
    make_inputs: Callable            # (shape, seed) -> tuple of CPU tensors
    call: Callable                   # (args, blocks) -> tensor
    flops: Callable                  # (shape,) -> float
    default_blocks: Callable         # (shape,) -> block tuple or None
    block_grid: Callable             # (shape,) -> list of block tuples
    tiny_shape: Tuple[int, ...]
    default_shape: Tuple[int, ...]


def _rng(seed: int):
    return np.random.default_rng(seed)


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def _flash_inputs(shape, seed):
    B, T, S, H, KV, D = shape
    r = _rng(seed)
    q = _f32(r.standard_normal((B, T, H, D)))
    k = _f32(r.standard_normal((B, S, KV, D)))
    v = _f32(r.standard_normal((B, S, KV, D)))
    return (q, k, v)


def _flash_call(args, blocks):
    bq, bk = blocks if blocks else (None, None)
    return ops.flash_attention(*args, causal=True, block_q=bq, block_k=bk)


def _flash_flops(shape):
    B, T, S, H, KV, D = shape
    # two (T, S) x D matmuls per head, causal halves the live scores
    return 4.0 * B * H * T * S * D * 0.5


def _flash_default(shape):
    return _fa.default_blocks(shape[-1])


def _flash_grid(shape):
    """The tiles K1 takes at this head dim: block_q a multiple of 4 up to
    64, block_k a multiple of 32, all within a block's shared memory."""
    D = shape[-1]
    return [(bq, bk) for bq in (16, 32, 64) for bk in (32, 64, 128)
            if _fa.fits_shared_memory(D, bq, bk)]


def _rmsnorm_inputs(shape, seed):
    rows, D = shape
    r = _rng(seed)
    x = _f32(r.standard_normal((rows, D)))
    w = _f32(r.standard_normal((D,)))
    return (x, w)


def _rmsnorm_call(args, blocks):
    br = blocks[0] if blocks else None
    return ops.rmsnorm(*args, block_rows=br)


def _rmsnorm_flops(shape):
    rows, D = shape
    return 4.0 * rows * D


def _rmsnorm_grid(shape):
    rows, _ = shape
    return [(b,) for b in (32, 64, 128, 256) if b <= max(32, rows)]


def _ssd_inputs(shape, seed):
    B, nc, Q, H, P, N = shape
    r = _rng(seed)
    xc = _f32(r.standard_normal((B, nc, Q, H, P)))
    dtc = _f32(r.uniform(0.1, 1.0, (B, nc, Q, H)))
    cum = _f32(np.cumsum(r.uniform(-0.1, 0.0, (B, nc, Q, H)), axis=2))
    Bc = _f32(r.standard_normal((B, nc, Q, N)))
    Cc = _f32(r.standard_normal((B, nc, Q, N)))
    return (xc, dtc, cum, Bc, Cc)


def _ssd_call(args, blocks):
    return ops.ssd_intra(*args)


def _ssd_flops(shape):
    B, nc, Q, H, P, N = shape
    return 2.0 * B * nc * H * Q * Q * (N + P)


OPS: Dict[str, OpSpec] = {
    "flash_attention": OpSpec(
        name="flash_attention", make_inputs=_flash_inputs, call=_flash_call,
        flops=_flash_flops, default_blocks=_flash_default,
        block_grid=_flash_grid,
        tiny_shape=(1, 128, 128, 2, 2, 32),
        default_shape=(2, 512, 512, 16, 16, 64)),
    "rmsnorm": OpSpec(
        name="rmsnorm", make_inputs=_rmsnorm_inputs, call=_rmsnorm_call,
        flops=_rmsnorm_flops,
        default_blocks=lambda shape: (_rn.DEFAULT_BLOCK_ROWS,),
        block_grid=_rmsnorm_grid,
        tiny_shape=(256, 128), default_shape=(4096, 2048)),
    "ssd_intra": OpSpec(
        name="ssd_intra", make_inputs=_ssd_inputs, call=_ssd_call,
        flops=_ssd_flops, default_blocks=lambda shape: None,
        block_grid=lambda shape: [None],
        tiny_shape=(1, 2, 64, 2, 32, 32),
        default_shape=(2, 4, 256, 8, 64, 128)),
}


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BenchResult:
    op: str
    shape: Tuple[int, ...]
    blocks: Optional[Tuple[int, ...]]
    median_s: float
    trials_s: Tuple[float, ...]
    flops: float
    device: str


def _resolve(run_device: DeviceLike) -> torch.device:
    if run_device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: kbench measures on the card; pass "
            "run_device='cpu' to time the plain versions on the CPU")
    return resolve_device(run_device)


def device_fingerprint(run_device: DeviceLike = None) -> str:
    """Stable identity of what a measurement actually ran on:
    ``cuda:<card name>``, or ``cpu:<machine>:plain`` for the plain versions
    on the CPU."""
    dev = _resolve(run_device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"cpu:{platform.machine() or 'unknown'}:plain"


def _time_s(fn, dev: torch.device) -> float:
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_op(op: str, shape: Sequence[int], *,
             blocks: Optional[Tuple[int, ...]] = None,
             trials: int = 5, warmup: int = 2,
             run_device: DeviceLike = None,
             seed: int = 0) -> BenchResult:
    """Median-of-``trials`` latency of one (op, shape, blocks) cell."""
    spec = OPS[op]
    shape = tuple(int(d) for d in shape)
    dev = _resolve(run_device)
    args = tuple(a.to(dev) for a in spec.make_inputs(shape, seed))

    def fn():
        spec.call(args, blocks)

    with torch.no_grad():
        for _ in range(max(1, warmup)):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        samples: List[float] = [_time_s(fn, dev) for _ in range(max(1, trials))]
    return BenchResult(op=op, shape=shape, blocks=blocks,
                       median_s=float(statistics.median(samples)),
                       trials_s=tuple(samples), flops=spec.flops(shape),
                       device=device_fingerprint(dev))


def measurement(res: BenchResult, *, device: Optional[str] = None,
                collected_at: Optional[float] = None,
                host: Optional[str] = None) -> KernelMeasurement:
    """Convert a BenchResult into a table row (stamping time + host)."""
    return KernelMeasurement(
        device=device or res.device, op=res.op, shape=res.shape,
        median_s=res.median_s, trials=len(res.trials_s), flops=res.flops,
        blocks=res.blocks,
        collected_at=time.time() if collected_at is None else collected_at,
        host=host or socket.gethostname())


def collect(ops_to_run: Optional[Sequence[str]] = None, *,
            shapes: str = "tiny", trials: int = 5, warmup: int = 2,
            run_device: DeviceLike = None, seed: int = 0,
            device: Optional[str] = None,
            collected_at: Optional[float] = None,
            host: Optional[str] = None) -> LatencyTable:
    """Measure every requested op at its canonical shape (default blocks).

    ``shapes`` picks the canonical set: "tiny" (CI-sized) or "default"
    (hardware-sized).  For the block-sweeping variant see
    ``repro_torch.kbench.autotune.collect_autotuned``."""
    table = LatencyTable()
    for name in ops_to_run or sorted(OPS):
        spec = OPS[name]
        shape = spec.tiny_shape if shapes == "tiny" else spec.default_shape
        res = bench_op(name, shape, blocks=spec.default_blocks(shape),
                       trials=trials, warmup=warmup, run_device=run_device,
                       seed=seed)
        table.add(measurement(res, device=device, collected_at=collected_at,
                              host=host))
    return table
