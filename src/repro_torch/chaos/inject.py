"""Deterministic failure injection at the runtime's state-bearing seams.

:class:`ChaosConfig` is the JSON-native knob block that rides on
``HarpConfig.chaos`` (schema v7); :class:`FaultInjector` turns it into
per-seam decision streams.  Three seams, matching where real jobs lose
state:

- **planner calls** — a search can time out (wall clock) or come back
  infeasible; the controller's degraded ladder must absorb both.
- **migration transfers** — any individual transfer of a live migration
  can fail; ``migrate.apply`` retries with exponential backoff, falls
  back to the checkpoint image per transfer, and aborts (rolling back to
  the old plan) when the budget is exhausted.
- **checkpoint writes** — a write can die mid-stream (partial write) or
  at fsync; the atomic-rename protocol must keep the previous checkpoint
  readable.

Determinism contract: each seam draws from its own ``random.Random``
stream seeded from ``(seed, seam name)``, so outcomes depend only on the
config and the *order of calls on that seam* — adding checkpoint writes
never changes which transfer fails.
"""
from __future__ import annotations

import random
from dataclasses import asdict, dataclass
from typing import Dict, Optional

_SEAMS = ("planner", "transfer", "ckpt", "migration")


@dataclass
class ChaosConfig:
    """Per-seam fault probabilities (0 disables a seam; all-zero = the
    off state, bit-identical to ``chaos=None``) plus retry shaping."""
    seed: int = 0
    p_planner_timeout: float = 0.0    # search exceeds its deadline
    p_planner_infeasible: float = 0.0  # search returns "no feasible strategy"
    p_transfer_failure: float = 0.0   # one migration transfer attempt fails
    p_ckpt_write_failure: float = 0.0  # checkpoint write dies mid-stream
    planner_timeout_s: float = 1.0    # wall clock a timed-out search burned
    max_transfer_retries: int = 3     # per-transfer attempts before fallback
    transfer_backoff_s: float = 0.05  # first retry's backoff
    transfer_backoff_mult: float = 2.0

    def to_dict(self) -> Dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ChaosConfig":
        return cls(**d)


class FaultInjector:
    """Seeded per-seam fault streams.  Counters under ``injected`` record
    how many faults each seam actually fired (for audit / benchmarks)."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._rng = {seam: random.Random(f"{cfg.seed}:{seam}")
                     for seam in _SEAMS}
        self.injected: Dict[str, int] = {seam: 0 for seam in _SEAMS}

    def _fire(self, seam: str, p: float) -> bool:
        if p <= 0:
            return False
        hit = self._rng[seam].random() < p
        if hit:
            self.injected[seam] += 1
        return hit

    # -- planner seam -------------------------------------------------------
    def planner_fault(self) -> Optional[str]:
        """Draw once per planner call: ``"timeout"``, ``"infeasible"`` or
        None.  A single draw decides both (timeout checked first), so each
        planner call consumes exactly one stream element."""
        r = self._rng["planner"].random()
        if self.cfg.p_planner_timeout > 0 and r < self.cfg.p_planner_timeout:
            self.injected["planner"] += 1
            return "timeout"
        if self.cfg.p_planner_infeasible > 0 and \
                r < self.cfg.p_planner_timeout + self.cfg.p_planner_infeasible:
            self.injected["planner"] += 1
            return "infeasible"
        return None

    # -- migration-transfer seam --------------------------------------------
    def transfer_fails(self) -> bool:
        """One draw per transfer *attempt* (retries re-draw)."""
        return self._fire("transfer", self.cfg.p_transfer_failure)

    def transfer_fault_fn(self):
        """Adapter matching ``migrate.apply.apply_migration``'s
        ``fault_fn(transfer, attempt) -> bool`` hook."""
        return lambda transfer, attempt: self.transfer_fails()

    # -- checkpoint-write seam ----------------------------------------------
    def ckpt_write_fault(self) -> Optional[str]:
        """Draw once per checkpoint write: ``"partial"`` (die mid-stream),
        ``"fsync"`` (die after the payload, before the atomic rename), or
        None.  Matches ``checkpoint.ckpt.set_write_fault``'s contract."""
        if not self._fire("ckpt", self.cfg.p_ckpt_write_failure):
            return None
        return "partial" if self._rng["ckpt"].random() < 0.5 else "fsync"

    def stats(self) -> Dict[str, int]:
        return dict(self.injected)
