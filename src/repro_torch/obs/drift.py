"""Predicted-vs-observed drift ledger.

Every committed plan carries a predicted ``SimResult`` digest
(``artifacts.sim_summary``); the trainer / replay harness observes actual
step times.  This module holds both sides to account and answers the one
question the EWMA calibrator alone can't: *how wrong was the plan*, per
step, per stage, per pool — the planner-accuracy evidence HAP / Poplar
lean on to validate their cost models.

- :class:`DriftLedger` — ``register_plan`` the prediction, ``observe_step``
  each measured step (optionally with per-stage times), ``report()`` the
  relative errors over a sliding window;
- :class:`DriftReport` — JSON-serializable: overall / per-stage / per-pool
  ``(observed - predicted) / predicted``, flagged when ``|error|`` exceeds
  the threshold.  The controller's drift-replan path keys off the same
  threshold, so a flagged report and a replan trigger agree by
  construction.

Pure arithmetic on caller-supplied samples — no clocks, no simulation:
feeding identical samples yields identical reports.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple


def _rel(observed: float, predicted: float) -> float:
    if predicted <= 0:
        return 0.0
    return (observed - predicted) / predicted


@dataclass
class DriftReport:
    """One windowed accounting of prediction error."""
    predicted_step_s: float
    observed_step_s: float          # mean over the window
    rel_error: float                # (observed - predicted) / predicted
    threshold: float
    window: int
    n_samples: int                  # samples in the window
    n_observed: int                 # samples ever observed
    flagged: bool
    per_stage: Dict[int, float] = field(default_factory=dict)
    per_pool: Dict[str, float] = field(default_factory=dict)
    flagged_stages: List[int] = field(default_factory=list)
    flagged_pools: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "predicted_step_s": self.predicted_step_s,
            "observed_step_s": self.observed_step_s,
            "rel_error": self.rel_error,
            "threshold": self.threshold,
            "window": self.window,
            "n_samples": self.n_samples,
            "n_observed": self.n_observed,
            "flagged": self.flagged,
            "per_stage": {str(k): v for k, v in sorted(self.per_stage.items())},
            "per_pool": {k: self.per_pool[k] for k in sorted(self.per_pool)},
            "flagged_stages": list(self.flagged_stages),
            "flagged_pools": list(self.flagged_pools),
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def describe(self) -> str:
        flag = "DRIFT" if self.flagged else "ok"
        pools = ", ".join(f"{p}={e:+.1%}"
                          for p, e in sorted(self.per_pool.items()))
        return (f"[{flag}] step {self.observed_step_s:.4f}s vs predicted "
                f"{self.predicted_step_s:.4f}s ({self.rel_error:+.1%}, "
                f"|thr| {self.threshold:.0%}, n={self.n_samples}"
                + (f"; {pools}" if pools else "") + ")")


class DriftLedger:
    """Sliding-window predicted-vs-observed accounting (module docstring).

    ``stage_pools`` (stage index -> pool/sub-cluster name) lets per-stage
    errors aggregate into per-pool errors — a 20% slowdown confined to one
    pool flags that pool, not the fleet.
    """

    def __init__(self, threshold: float = 0.15, window: int = 8):
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.threshold = float(threshold)
        self.window = int(window)
        self.predicted_step_s: float = 0.0
        self.predicted_stage_s: List[float] = []
        self.stage_pools: Dict[int, str] = {}
        self.plan_registrations = 0
        self.n_observed = 0
        self._steps: Deque[Tuple[int, float]] = deque(maxlen=window)
        self._stage: Deque[Sequence[float]] = deque(maxlen=window)

    # -- feeding -------------------------------------------------------------

    def register_plan(self, predicted: Dict[str, Any], *,
                      stage_pools: Optional[Dict[int, str]] = None) -> None:
        """Adopt a committed plan's predicted digest (``sim_summary``-shaped
        dict: ``makespan_s`` required, ``stage_compute_s`` optional) and
        restart the observation window — samples from the old plan don't
        indict the new one."""
        self.predicted_step_s = float(predicted["makespan_s"])
        self.predicted_stage_s = [
            float(x) for x in predicted.get("stage_compute_s", [])]
        self.stage_pools = dict(stage_pools or {})
        self.plan_registrations += 1
        self._steps.clear()
        self._stage.clear()

    def observe_step(self, step: int, step_time_s: float,
                     stage_times: Optional[Sequence[float]] = None) -> None:
        self.n_observed += 1
        self._steps.append((int(step), float(step_time_s)))
        if stage_times is not None:
            self._stage.append([float(x) for x in stage_times])

    # -- reporting -----------------------------------------------------------

    def report(self) -> DriftReport:
        n = len(self._steps)
        observed = (sum(t for _, t in self._steps) / n) if n else 0.0
        rel = _rel(observed, self.predicted_step_s) if n else 0.0
        per_stage: Dict[int, float] = {}
        if self._stage and self.predicted_stage_s:
            k = min(len(self.predicted_stage_s),
                    min(len(row) for row in self._stage))
            for i in range(k):
                mean_i = sum(row[i] for row in self._stage) / len(self._stage)
                per_stage[i] = _rel(mean_i, self.predicted_stage_s[i])
        per_pool: Dict[str, float] = {}
        if per_stage and self.stage_pools:
            acc: Dict[str, List[float]] = {}
            for i, e in per_stage.items():
                pool = self.stage_pools.get(i)
                if pool is not None:
                    acc.setdefault(pool, []).append(e)
            per_pool = {p: sum(v) / len(v) for p, v in acc.items()}
        flagged_stages = [i for i, e in sorted(per_stage.items())
                          if abs(e) > self.threshold]
        flagged_pools = [p for p in sorted(per_pool)
                         if abs(per_pool[p]) > self.threshold]
        flagged = bool(n) and (abs(rel) > self.threshold
                               or bool(flagged_pools))
        return DriftReport(
            predicted_step_s=self.predicted_step_s,
            observed_step_s=observed, rel_error=rel,
            threshold=self.threshold, window=self.window,
            n_samples=n, n_observed=self.n_observed, flagged=flagged,
            per_stage=per_stage, per_pool=per_pool,
            flagged_stages=flagged_stages, flagged_pools=flagged_pools)
