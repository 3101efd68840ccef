"""repro_torch.kbench — measured-kernel cost model, on the card.

Counterpart of ``repro/kbench``; it closes the loop from the port's Hopper
kernels to the planner:

  - ``harness``  — microbenchmark runner for the entry points in
    ``kernels/ops.py`` (numpy-seeded inputs, warmup, every call timed on the
    card with CUDA events, median of k trials); the CPU runs the plain
    versions only when asked and stamps its cells ``cpu:...:plain``;
  - ``autotune`` — block-size autotuner sweeping the tiling grids per
    (device, op, shape), installing winners into the kernel entry points'
    tuned-block registry;
  - ``table``    — the reference's JSON latency table (schema 1, a verbatim
    copy), so either package reads what the other writes;
  - ``bridge``   — adapts the table into the planner's cost model
    (``PlannerConfig.kbench=KBenchConfig(...)``); ``kbench=None`` is
    bit-identical to the analytic-only planner.

Layering: ``table``/``bridge`` are pure Python; ``harness``/``autotune``
import torch, and build no kernel until one is launched.
"""
from repro_torch.kbench.table import KernelMeasurement, LatencyTable, shape_bucket
from repro_torch.kbench.bridge import KBenchConfig, KBenchModel

__all__ = [
    "KernelMeasurement",
    "LatencyTable",
    "shape_bucket",
    "KBenchConfig",
    "KBenchModel",
]
