"""Reference executor for migration plans: host-side byte-level resharding.

Every leaf is a flat byte array (``np.uint8``); a :class:`ShardedState`
keeps, per (leaf, device), the full-size buffer with only the *held*
intervals materialized.  :func:`apply_migration` executes a
:class:`~repro_torch.migrate.differ.MigrationPlan` transfer by transfer —
reading each byte run from the source device's buffer (or the checkpoint
image for ``src=None`` restores) — and counts exactly what went over the
wire, so tests can assert:

- **bit-identity**: the migrated state equals initializing directly in the
  new layout (``shard_state(new_layout, full)``), byte for byte;
- **moved-bytes exactness**: live bytes shipped == the differ's
  ``moved_bytes``, checkpoint bytes == ``ckpt_bytes`` — the bound the
  preemption acceptance test holds the replay to.

This is the semantic ground truth the priced migration models; a real
device runtime would execute the same Transfer list with device puts.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.migrate.differ import MigrationPlan
from repro_torch.migrate.layout import (
    DeviceId, Interval, PlanLayout, length, normalize,
)


@dataclass
class ShardedState:
    """Per-(leaf, device) held intervals + backing buffers."""
    layout: PlanLayout
    data: Dict[Tuple[str, DeviceId], np.ndarray] = field(default_factory=dict)
    held: Dict[Tuple[str, DeviceId], List[Interval]] = \
        field(default_factory=dict)

    def buffer(self, leaf: str, dev: DeviceId) -> np.ndarray:
        key = (leaf, dev)
        if key not in self.data:
            self.data[key] = np.zeros(self.layout.leaves[leaf].nbytes,
                                      dtype=np.uint8)
            self.held[key] = []
        return self.data[key]

    def holds(self, leaf: str, dev: DeviceId, start: int, end: int) -> bool:
        for s, e in self.held.get((leaf, dev), []):
            if s <= start and end <= e:
                return True
        return False

    def read(self, leaf: str, dev: DeviceId, start: int, end: int
             ) -> np.ndarray:
        if not self.holds(leaf, dev, start, end):
            raise KeyError(
                f"{dev} does not hold {leaf}[{start}:{end}]")
        return self.data[(leaf, dev)][start:end]

    def write(self, leaf: str, dev: DeviceId, start: int,
              payload: np.ndarray) -> None:
        buf = self.buffer(leaf, dev)
        buf[start:start + len(payload)] = payload
        key = (leaf, dev)
        self.held[key] = normalize(self.held[key]
                                   + [(start, start + len(payload))])


def shard_state(layout: PlanLayout, full: Dict[str, np.ndarray]
                ) -> ShardedState:
    """Direct initialization: place ``full`` leaf byte arrays into
    ``layout``'s holdings (the ground truth the migrated state must
    match)."""
    st = ShardedState(layout)
    for leaf, hold in layout.holdings.items():
        arr = np.asarray(full[leaf], dtype=np.uint8)
        if len(arr) != layout.leaves[leaf].nbytes:
            raise ValueError(
                f"{leaf}: got {len(arr)} bytes, layout expects "
                f"{layout.leaves[leaf].nbytes}")
        for dev, ivs in hold.items():
            for s, e in ivs:
                st.write(leaf, dev, s, arr[s:e])
    return st


@dataclass
class ApplyStats:
    live_bytes: int = 0            # shipped device-to-device
    ckpt_bytes: int = 0            # restored from the checkpoint image
    n_transfers: int = 0
    retries: int = 0               # failed transfer attempts that re-drew
    backoff_s: float = 0.0         # exponential-backoff wall charged
    ckpt_fallbacks: int = 0        # transfers served from the checkpoint
                                   # image after their retry budget drained


@dataclass
class RetryPolicy:
    """Per-transfer retry shaping: attempt ``1 + max_retries`` times, waiting
    ``backoff_s * mult**(attempt - 1)`` before retry ``attempt``."""
    max_retries: int = 3
    backoff_s: float = 0.05
    mult: float = 2.0

    def total_backoff(self, n_retries: int) -> float:
        return sum(self.backoff_s * self.mult ** i for i in range(n_retries))


class MigrationAborted(RuntimeError):
    """A transfer exhausted its retry budget with no checkpoint fallback.
    ``apply_migration`` never mutates the input ``state``, so the caller's
    rollback is simply to keep running the old plan on it — the partial
    ``out`` state is discarded with this exception.  Carries the stats
    accumulated up to the abort (the wasted work to charge)."""

    def __init__(self, msg: str, stats: "ApplyStats"):
        super().__init__(msg)
        self.stats = stats


def apply_migration(state: ShardedState, mplan: MigrationPlan,
                    new_layout: PlanLayout, *,
                    lost: Optional[Set[DeviceId]] = None,
                    ckpt_image: Optional[Dict[str, np.ndarray]] = None,
                    fault_fn=None,
                    retry: Optional[RetryPolicy] = None
                    ) -> Tuple[ShardedState, ApplyStats]:
    """Execute ``mplan`` against ``state`` (the old layout's holdings),
    producing the new layout's state.  Bytes already in place on surviving
    devices are copied locally (not counted as moved); ``src=None``
    restores read ``ckpt_image``; reading from a ``lost`` device raises —
    the differ must never schedule one as a source.

    Fault path: ``fault_fn(transfer, attempt) -> bool`` (True = this attempt
    fails) injects per-transfer failures.  A failed transfer retries with
    exponential backoff per ``retry`` (default :class:`RetryPolicy`); when
    the budget drains it falls back to the checkpoint image for that leaf
    (counted in ``ckpt_fallbacks`` + ``ckpt_bytes``), and when no image
    covers it, raises :class:`MigrationAborted` — ``state`` is untouched,
    so the caller rolls back by keeping the old plan."""
    lost = lost or set()
    retry = retry or RetryPolicy()
    out = ShardedState(new_layout)
    stats = ApplyStats()
    # bytes that never move: same device holds them under both layouts
    for leaf, hold in new_layout.holdings.items():
        for dev, ivs in hold.items():
            if dev in lost:
                raise ValueError(f"new layout places {leaf} on lost {dev}")
            for s, e in ivs:
                for os_, oe in state.held.get((leaf, dev), []):
                    cs, ce = max(s, os_), min(e, oe)
                    if cs < ce:
                        out.write(leaf, dev, cs, state.read(leaf, dev, cs, ce))
    for t in mplan.transfers:
        if t.src is not None and t.src in lost:
            raise ValueError(f"differ scheduled lost device {t.src} "
                             f"as a source for {t.leaf}")
        if t.src is None and (ckpt_image is None or t.leaf not in ckpt_image):
            raise ValueError(
                f"transfer of {t.leaf} needs a checkpoint image "
                f"(no surviving replica)")
        # attempt loop: live read, per-attempt fault draw, exponential
        # backoff, then the checkpoint image as the per-transfer fallback
        attempt = 0
        from_ckpt = t.src is None
        while True:
            if fault_fn is None or from_ckpt \
                    or not fault_fn(t, attempt):
                break
            stats.retries += 1
            stats.backoff_s += retry.backoff_s * retry.mult ** attempt
            attempt += 1
            if attempt > retry.max_retries:
                if ckpt_image is not None and t.leaf in ckpt_image:
                    from_ckpt = True
                    stats.ckpt_fallbacks += 1
                    break
                raise MigrationAborted(
                    f"transfer {t.leaf}[{t.start}:{t.end}] "
                    f"{t.src} -> {t.dst} failed {attempt} times with no "
                    f"checkpoint fallback; rolling back to the old plan",
                    stats)
        if from_ckpt:
            payload = np.asarray(ckpt_image[t.leaf],
                                 dtype=np.uint8)[t.start:t.end]
            stats.ckpt_bytes += t.nbytes
        else:
            payload = state.read(t.leaf, t.src, t.start, t.end)
            stats.live_bytes += t.nbytes
        out.write(t.leaf, t.dst, t.start, np.array(payload, copy=True))
        stats.n_transfers += 1
    return out, stats


def gather_leaf(state: ShardedState, leaf: str) -> np.ndarray:
    """Reconstruct one full leaf from the holdings; raises if any byte is
    uncovered (a layout must tile every leaf completely)."""
    spec = state.layout.leaves[leaf]
    arr = np.zeros(spec.nbytes, dtype=np.uint8)
    covered: List[Interval] = []
    for dev, ivs in state.layout.holdings.get(leaf, {}).items():
        for s, e in ivs:
            arr[s:e] = state.read(leaf, dev, s, e)
            covered.append((s, e))
    covered = normalize(covered)
    if length(covered) != spec.nbytes or \
            (covered and (covered[0][0] != 0 or covered[-1][1] != spec.nbytes)):
        raise ValueError(f"{leaf}: holdings cover {covered}, "
                         f"expected [0, {spec.nbytes})")
    return arr


def states_equal(a: ShardedState, b: ShardedState) -> bool:
    """Bit-identity over every (leaf, device, interval) of ``b``'s
    layout."""
    for leaf, hold in b.layout.holdings.items():
        for dev, ivs in hold.items():
            for s, e in ivs:
                if not a.holds(leaf, dev, s, e):
                    return False
                if not np.array_equal(a.read(leaf, dev, s, e),
                                      b.read(leaf, dev, s, e)):
                    return False
    return True
