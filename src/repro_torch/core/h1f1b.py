"""H-1F1B: heterogeneity-aware 1F1B warm-up schedule (paper §4).

Stage i launches ``N_i = 1 + sum_{k>=i} delta_k`` forward microbatches during
warm-up.  ``delta_i`` compensates the inter-stage communication cost c_i:

  exact rule (Eq. 10/11):  delta_i = ceil(1 + 2*c_i / (f+b))
  banded rule  (Eq. 2):    1 / 2 / 3 for c_i in (0, eps*tmax] /
                           (eps*tmax, tmax/2] / (tmax/2, tmax]

Baselines: classic 1F1B launches ``S - i + 1``; Eager-1F1B launches
``2*(S - i) + 1``.  All counts are capped by the number of microbatches.
"""
from __future__ import annotations

import math
from typing import List, Sequence


def h1f1b_deltas(t_per_stage: Sequence[float], c_links: Sequence[float],
                 eps: float = 0.05, banded: bool = False) -> List[int]:
    """delta_i for i = 1..S-1 (list of length S-1).

    ``t_per_stage``: per-microbatch f+b compute cost per stage;
    ``c_links[i]``: communication cost between stage i and i+1."""
    S = len(t_per_stage)
    assert len(c_links) == S - 1
    t_max = max(t_per_stage)
    out: List[int] = []
    for c in c_links:
        if c <= eps * t_max:
            # negligible comm: one extra launch suffices (Eq. 2 first band);
            # the strict Eq. 10 ceiling would waste a buffer here
            out.append(1)
        elif banded:
            out.append(2 if c <= t_max / 2 else 3)
        else:
            out.append(max(1, math.ceil(1.0 + 2.0 * c / t_max)))
    return out


def h1f1b_counts(t_per_stage: Sequence[float], c_links: Sequence[float],
                 n_microbatches: int, eps: float = 0.05,
                 banded: bool = False) -> List[int]:
    """Warm-up launch counts N_i (Eq. 1), capped at the microbatch count."""
    S = len(t_per_stage)
    deltas = h1f1b_deltas(t_per_stage, c_links, eps=eps, banded=banded)
    counts = [1] * S
    for i in range(S - 2, -1, -1):
        counts[i] = counts[i + 1] + deltas[i]
    return [min(c, n_microbatches) for c in counts]


def classic_1f1b_counts(S: int, n_microbatches: int) -> List[int]:
    return [min(S - i, n_microbatches) for i in range(S)]


def eager_1f1b_counts(S: int, n_microbatches: int) -> List[int]:
    return [min(2 * (S - 1 - i) + 1, n_microbatches) for i in range(S)]


def memory_ok(mem_p: float, mem_a: float, warmup_k: int, cap: float) -> bool:
    """Eq. 18."""
    return mem_p + warmup_k * mem_a <= cap


def steady_latency_2stage(f: float, b: float, c: float, K: int) -> float:
    """Closed-form K-block duration (Eq. 8): Lambda_K / K per microbatch."""
    return max(K * (f + b), 2 * (f + b + c)) / K
