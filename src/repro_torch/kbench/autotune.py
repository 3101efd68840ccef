"""Block-size autotuner: sweep tiling grids, record winners, install them.

Counterpart of ``repro/kbench/autotune.py``.  For each (device, op, shape)
the sweep measures every block config in the op's grid (the default config
is always a member, so the winner is never slower than the default *on the
same measurements*) and keeps the argmin median with a deterministic
tie-break on the block tuple.  Winners land in the
:class:`~repro_torch.kbench.table.LatencyTable` as ordinary measurements —
``best_blocks`` reads them back out, and :func:`install` pushes them into
the tuned-block registry in ``kernels/ops.py`` so entry points called with
``block_q=None``-style defaults pick them up transparently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.device import DeviceLike
from repro_torch.kbench.table import LatencyTable


@dataclass(frozen=True)
class SweepResult:
    op: str
    shape: Tuple[int, ...]
    device: str
    best_blocks: Optional[Tuple[int, ...]]
    best_s: float
    default_blocks: Optional[Tuple[int, ...]]
    default_s: float
    sweep: Tuple[Tuple[Optional[Tuple[int, ...]], float], ...]

    @property
    def speedup(self) -> float:
        """Default-vs-winner latency ratio (>= 1.0 by construction)."""
        return self.default_s / self.best_s if self.best_s > 0 else 1.0


def sweep(op: str, shape: Sequence[int], *, trials: int = 5, warmup: int = 2,
          run_device: DeviceLike = None, seed: int = 0) -> SweepResult:
    """Measure every block config in the op's grid at ``shape``."""
    from repro_torch.kbench import harness

    spec = harness.OPS[op]
    shape = tuple(int(d) for d in shape)
    default = spec.default_blocks(shape)
    grid = list(spec.block_grid(shape))
    if default is not None and default not in grid:
        grid.append(default)
    results = []
    for blocks in grid:
        res = harness.bench_op(op, shape, blocks=blocks, trials=trials,
                               warmup=warmup, run_device=run_device, seed=seed)
        results.append((blocks, res.median_s))
    best_blocks, best_s = min(results, key=lambda r: (r[1], r[0] or ()))
    default_s = next(s for b, s in results if b == default)
    return SweepResult(op=op, shape=shape,
                       device=harness.device_fingerprint(run_device),
                       best_blocks=best_blocks, best_s=best_s,
                       default_blocks=default,
                       default_s=default_s, sweep=tuple(results))


def collect_autotuned(ops_to_run: Optional[Sequence[str]] = None, *,
                      shapes: str = "tiny", trials: int = 5, warmup: int = 2,
                      run_device: DeviceLike = None, seed: int = 0,
                      device: Optional[str] = None,
                      collected_at: Optional[float] = None,
                      host: Optional[str] = None,
                      ) -> Tuple[LatencyTable, List[SweepResult]]:
    """Sweep every requested op; the table records the winning cells."""
    from repro_torch.kbench import harness

    table = LatencyTable()
    sweeps: List[SweepResult] = []
    for name in ops_to_run or sorted(harness.OPS):
        spec = harness.OPS[name]
        shape = spec.tiny_shape if shapes == "tiny" else spec.default_shape
        sw = sweep(name, shape, trials=trials, warmup=warmup,
                   run_device=run_device, seed=seed)
        sweeps.append(sw)
        # the sweep already timed the winner — record it without re-running
        res = harness.BenchResult(op=name, shape=shape,
                                  blocks=sw.best_blocks,
                                  median_s=sw.best_s,
                                  trials_s=(sw.best_s,) * max(1, trials),
                                  flops=spec.flops(shape), device=sw.device)
        table.add(harness.measurement(res, device=device,
                                      collected_at=collected_at, host=host))
    return table, sweeps


def best_blocks(op: str, shape: Sequence[int], device: str,
                table: LatencyTable) -> Optional[Tuple[int, ...]]:
    """Winning block config recorded in ``table`` (None = untuned)."""
    return table.best_blocks(device, op, shape)


def install(table: LatencyTable, device: Optional[str] = None) -> int:
    """Push a table's winners into the ops tuned-block registry.

    Only entries for ``device`` (default: the card's fingerprint, which
    raises without a card) are installed — a table merged across hosts holds
    cells for devices this process doesn't have.  Returns the number of
    installed configs."""
    from repro_torch.kbench import harness
    from repro_torch.kernels import ops

    device = device or harness.device_fingerprint()
    n = 0
    for e in table.for_device(device):
        if e.blocks:
            ops.set_tuned_blocks(e.op, e.shape, e.blocks)
            n += 1
    return n
