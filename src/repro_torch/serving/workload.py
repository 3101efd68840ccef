"""Typed serving request traces.

The serving analog of :mod:`repro_torch.runtime.events`: a trace is an immutable,
sorted tuple of frozen :class:`Request` values, produced either by a seeded
generator (:func:`poisson_trace` — Poisson arrivals, log-normal
prompt/output lengths, deterministic per seed) or a *scripted* process
(:func:`scripted_trace` — evenly spaced arrivals with fixed lengths, the
regression-fixture flavor).

Recorded traces replay at a different load via the time-remapping idiom
(:meth:`ServeTrace.remapped`): inter-arrival gaps are rescaled so the same
request population — same lengths, same order — arrives at a target QPS.
That is how one recorded workload sweeps a QPS axis without resampling.

No jax imports; traces are JSON round-trippable (they ride inside the
schema-v4 plan artifact's provenance and the benchmark output).
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Any, Dict, Sequence, Tuple


@dataclass(frozen=True)
class Request:
    """One inference request: arrives at ``arrival_s``, carries a prompt of
    ``prompt_tokens`` and wants ``output_tokens`` decoded."""
    rid: int
    arrival_s: float
    prompt_tokens: int
    output_tokens: int

    def describe(self) -> str:
        return (f"req{self.rid}@{self.arrival_s:.3f}s "
                f"({self.prompt_tokens}+{self.output_tokens} tok)")


@dataclass(frozen=True)
class ServeTrace:
    """Requests sorted by arrival time."""
    requests: Tuple[Request, ...]

    def __post_init__(self):
        arr = [r.arrival_s for r in self.requests]
        if arr != sorted(arr):
            object.__setattr__(
                self, "requests",
                tuple(sorted(self.requests, key=lambda r: (r.arrival_s,
                                                           r.rid))))

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def qps(self) -> float:
        """Mean arrival rate over the trace span."""
        if self.n_requests < 2 or self.duration_s <= 0:
            return float(self.n_requests)
        return (self.n_requests - 1) / self.duration_s

    @property
    def total_prompt_tokens(self) -> int:
        return sum(r.prompt_tokens for r in self.requests)

    @property
    def total_output_tokens(self) -> int:
        return sum(r.output_tokens for r in self.requests)

    # -- replay idioms -------------------------------------------------------

    def remapped(self, qps: float) -> "ServeTrace":
        """Time-remapped replay: the same requests (lengths, order) with
        inter-arrival gaps rescaled to a mean rate of ``qps``."""
        if qps <= 0:
            raise ValueError(f"target qps must be positive, got {qps}")
        cur = self.qps
        if cur <= 0 or self.n_requests < 2:
            return self
        scale = cur / qps
        return ServeTrace(tuple(
            Request(r.rid, r.arrival_s * scale, r.prompt_tokens,
                    r.output_tokens) for r in self.requests))

    def take(self, n: int) -> "ServeTrace":
        """Prefix of the trace (placement-search sampling)."""
        return self if n <= 0 or n >= self.n_requests \
            else ServeTrace(self.requests[:n])

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"requests": [[r.rid, r.arrival_s, r.prompt_tokens,
                              r.output_tokens] for r in self.requests]}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ServeTrace":
        return ServeTrace(tuple(Request(int(a), float(b), int(c), int(e))
                                for a, b, c, e in d["requests"]))

    def describe(self) -> str:
        if not self.requests:
            return "(empty trace)"
        return (f"{self.n_requests} requests over {self.duration_s:.2f}s "
                f"({self.qps:.1f} qps), "
                f"{self.total_prompt_tokens} prompt + "
                f"{self.total_output_tokens} output tokens")


def _lognormal_tokens(rng: random.Random, mean: int, lo: int,
                      sigma: float = 0.6) -> int:
    """Integer token count ~ LogNormal with the requested mean, clamped to
    [lo, 8*mean] (an unclamped tail occasionally draws a prompt longer than
    any pool's KV capacity, which only tests rejection paths)."""
    mu = math.log(mean) - sigma * sigma / 2.0
    return max(lo, min(8 * mean, int(round(rng.lognormvariate(mu, sigma)))))


def poisson_trace(qps: float, duration_s: float, *, seed: int = 0,
                  prompt_mean: int = 512, output_mean: int = 64,
                  prompt_min: int = 16, output_min: int = 4) -> ServeTrace:
    """Seeded Poisson arrival process with log-normal length marginals.
    Deterministic per (seed, qps, duration, means)."""
    if qps <= 0 or duration_s <= 0:
        raise ValueError("poisson_trace needs positive qps and duration_s")
    rng = random.Random(seed)
    reqs = []
    t = 0.0
    while True:
        t += rng.expovariate(qps)
        if t >= duration_s:
            break
        reqs.append(Request(
            rid=len(reqs), arrival_s=t,
            prompt_tokens=_lognormal_tokens(rng, prompt_mean, prompt_min),
            output_tokens=_lognormal_tokens(rng, output_mean, output_min)))
    return ServeTrace(tuple(reqs))


def scripted_trace(qps: float, n_requests: int, *, prompt_tokens: int = 512,
                   output_tokens: int = 64) -> ServeTrace:
    """Deterministic fixture: ``n_requests`` evenly spaced at rate ``qps``,
    all with identical lengths (golden tests, benchmark floors)."""
    if qps <= 0 or n_requests <= 0:
        raise ValueError("scripted_trace needs positive qps and n_requests")
    gap = 1.0 / qps
    return ServeTrace(tuple(
        Request(rid=i, arrival_s=i * gap, prompt_tokens=prompt_tokens,
                output_tokens=output_tokens) for i in range(n_requests)))
