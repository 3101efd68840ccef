"""Serving objectives: latency-SLO and max-throughput scoring.

The placement search minimizes :func:`score` over candidate plans, under
the objective named in ``ServingConfig.objective``:

- ``"slo"`` — meet p99 TTFT (time-to-first-token) and p99 TPOT
  (time-per-output-token) targets at the offered QPS.  The score is a
  lexicographic penalty: rejected requests dominate, then relative SLO
  excess, then raw p99 TTFT as the tiebreak among plans that meet the SLO
  — so among feasible plans the search still prefers snappier ones.
- ``"throughput"`` — maximize goodput (output tokens/s of requests that
  met both SLOs); rejections still count against the plan through the
  goodput they forfeit.

Deterministic, numpy-free percentile (linear interpolation, the numpy
default) so scores are bit-stable across platforms.
"""
from __future__ import annotations

import math
from typing import Sequence

OBJECTIVES = ("slo", "throughput")


def percentile(samples: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method), 0 on an
    empty sample set."""
    if not samples:
        return 0.0
    xs = sorted(samples)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def score(result, objective: str, *, slo_ttft_s: float,
          slo_tpot_s: float) -> float:
    """Lower is better.  ``result`` is a
    :class:`repro_torch.serving.batching.ServeSimResult`."""
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown serving objective {objective!r}; one of {OBJECTIVES}")
    n = result.n_completed + result.n_rejected
    rej_frac = result.n_rejected / n if n else 0.0
    if objective == "throughput":
        return rej_frac * 1e12 - result.goodput_tokens_per_s
    # "slo": penalty units are chosen so each tier dominates the next —
    # rejections >> SLO violation >> raw latency
    excess = max(0.0, result.p99_ttft_s / slo_ttft_s - 1.0) \
        + max(0.0, result.p99_tpot_s / slo_tpot_s - 1.0)
    return rej_frac * 1e6 + excess * 1e3 + result.p99_ttft_s


def better(a: float, b: float) -> bool:
    """Is score ``a`` strictly better than ``b``?"""
    return a < b
