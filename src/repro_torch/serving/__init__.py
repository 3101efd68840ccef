"""Heterogeneity-aware inference planning (DESIGN.md §7).

HARP's core move — place work on the pool whose compute/memory/network
profile suits it — applied to serving: prefill is compute-bound (suits the
high-FLOPs sub-clusters), decode is memory-bandwidth/KV-capacity-bound
(suits the memory-rich stragglers).  The subsystem mirrors the training
stack's staging:

- :mod:`repro_torch.serving.workload`  — typed request traces (the input);
- :mod:`repro_torch.serving.kvplan`    — the KV-cache capacity bound (Eq. 18's
  serving analog) with paged-block accounting;
- :mod:`repro_torch.serving.placement` — disaggregated prefill/decode placement
  search over the fleet's pools, KV handoff priced through
  :mod:`repro_torch.comm`'s tiered links;
- :mod:`repro_torch.serving.batching`  — event-driven continuous-batching
  simulator (admission control, prefill chunking, decode step batching);
- :mod:`repro_torch.serving.objective` — latency-SLO and max-throughput scoring.

None of these import jax: like the planner stack, serving plans are
searchable on a CPU-only box and ship as JSON (the ``serve`` section of the
schema-v4 Plan artifact).
"""
from repro_torch.serving.batching import ServeSimResult, simulate_trace
from repro_torch.serving.kvplan import (
    KVBound, blocks_for_seq, decode_capacity, kv_bytes_per_token,
    state_bytes_per_seq,
)
from repro_torch.serving.objective import percentile, score
from repro_torch.serving.placement import (
    PoolSpec, ServePlan, ServingConfig, colocated_plan, search_placement,
)
from repro_torch.serving.workload import (
    Request, ServeTrace, poisson_trace, scripted_trace,
)

__all__ = [
    "KVBound", "PoolSpec", "Request", "ServePlan", "ServeSimResult",
    "ServeTrace", "ServingConfig", "blocks_for_seq", "colocated_plan",
    "decode_capacity", "kv_bytes_per_token", "percentile", "poisson_trace",
    "score", "scripted_trace", "search_placement", "simulate_trace",
    "state_bytes_per_seq",
]
