"""Measured-latency table: JSON-persisted, bucketed, mergeable.

One :class:`KernelMeasurement` records the median latency of one (device,
op, shape, block-config) cell.  Shapes are *bucketed* (every dim rounded up
to a power of two) so a table collected on a handful of representative
shapes can price nearby shapes via nearest-bucket interpolation scaled by
the FLOP (or element-count) ratio.

Merge policy (deterministic, commutative up to the stated tie-breaks): for
cells with the same (device, op, bucket, blocks) key the *newer*
``collected_at`` stamp wins; on equal stamps the lower latency wins (both
hosts measured the same cell — keep the better-conditioned run).  Entries
are kept sorted so serialization is canonical regardless of insert order.

This module is pure Python (no jax) — the planner imports it freely.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

TABLE_SCHEMA = 1


def _pow2_ceil(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def shape_bucket(shape: Iterable[int]) -> Tuple[int, ...]:
    """Canonical bucket for a shape: each dim rounded up to a power of two."""
    return tuple(_pow2_ceil(d) for d in shape)


@dataclass(frozen=True)
class KernelMeasurement:
    """One measured cell of the latency table."""

    device: str                      # device fingerprint, e.g. "tpu:TPU v5e"
    op: str                          # op name in the harness registry
    shape: Tuple[int, ...]           # the shape actually measured
    median_s: float                  # median wall-clock seconds per call
    trials: int                      # number of timed trials behind the median
    flops: float                     # analytic FLOP count at `shape` (0 = n/a)
    blocks: Optional[Tuple[int, ...]]  # block config measured (None = default)
    collected_at: float              # unix seconds (staleness stamp)
    host: str                        # hostname the measurement came from

    @property
    def bucket(self) -> Tuple[int, ...]:
        return shape_bucket(self.shape)

    @property
    def key(self) -> Tuple:
        return (self.device, self.op, self.bucket,
                self.blocks if self.blocks is not None else ())

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["blocks"] = None if self.blocks is None else list(self.blocks)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "KernelMeasurement":
        return KernelMeasurement(
            device=str(d["device"]), op=str(d["op"]),
            shape=tuple(int(x) for x in d["shape"]),
            median_s=float(d["median_s"]), trials=int(d["trials"]),
            flops=float(d.get("flops", 0.0)),
            blocks=(None if d.get("blocks") is None
                    else tuple(int(x) for x in d["blocks"])),
            collected_at=float(d.get("collected_at", 0.0)),
            host=str(d.get("host", "")))


def _bucket_dist(a: Tuple[int, ...], b: Tuple[int, ...]) -> float:
    return sum(abs(math.log2(x) - math.log2(y)) for x, y in zip(a, b))


class LatencyTable:
    """A set of :class:`KernelMeasurement` with lookup/merge/persistence."""

    def __init__(self, entries: Optional[Iterable[KernelMeasurement]] = None):
        self.entries: List[KernelMeasurement] = []
        for e in entries or ():
            self.add(e)

    # -- construction -------------------------------------------------------

    def add(self, m: KernelMeasurement) -> None:
        """Insert, applying the merge policy against any same-key entry."""
        for i, e in enumerate(self.entries):
            if e.key == m.key:
                self.entries[i] = self._prefer(e, m)
                break
        else:
            self.entries.append(m)
        self.entries.sort(key=lambda e: (e.device, e.op, e.bucket,
                                         e.blocks or (), e.shape))

    @staticmethod
    def _prefer(a: KernelMeasurement, b: KernelMeasurement) -> KernelMeasurement:
        # newer stamp wins; equal stamps -> lower latency wins
        if a.collected_at != b.collected_at:
            return a if a.collected_at > b.collected_at else b
        return a if a.median_s <= b.median_s else b

    def merge(self, other: "LatencyTable") -> "LatencyTable":
        out = LatencyTable(self.entries)
        for e in other.entries:
            out.add(e)
        return out

    # -- queries ------------------------------------------------------------

    def fresh(self, max_age_s: float = 0.0,
              now: Optional[float] = None) -> "LatencyTable":
        """Entries no older than ``max_age_s`` (0 = everything is fresh)."""
        if not max_age_s:
            return self
        if now is None:
            now = max((e.collected_at for e in self.entries), default=0.0)
        return LatencyTable(e for e in self.entries
                            if now - e.collected_at <= max_age_s)

    def devices(self) -> List[str]:
        return sorted({e.device for e in self.entries})

    def for_device(self, device: str) -> List[KernelMeasurement]:
        return [e for e in self.entries if e.device == device]

    def lookup(self, device: str, op: str,
               shape: Iterable[int]) -> Optional[KernelMeasurement]:
        """Nearest-bucket entry for (device, op, shape); None if uncovered.

        Exact bucket match wins; otherwise the same-rank entry with the
        smallest log2 bucket distance (deterministic tie-break on the
        bucket tuple, then on the block config)."""
        shape = tuple(int(d) for d in shape)
        want = shape_bucket(shape)
        cands = [e for e in self.entries
                 if e.device == device and e.op == op
                 and len(e.bucket) == len(want)]
        if not cands:
            return None
        return min(cands, key=lambda e: (_bucket_dist(e.bucket, want),
                                         e.bucket, e.blocks or ()))

    def estimate_s(self, device: str, op: str, shape: Iterable[int],
                   flops: Optional[float] = None) -> Optional[float]:
        """Interpolated latency estimate at ``shape`` (None if uncovered).

        Scales the nearest bucket's measured latency by the FLOP ratio when
        the caller supplies the query shape's FLOP count (and the entry
        recorded one), else by the element-count ratio."""
        shape = tuple(int(d) for d in shape)
        e = self.lookup(device, op, shape)
        if e is None:
            return None
        if flops is not None and e.flops > 0:
            return e.median_s * (flops / e.flops)
        ours = 1
        for d in shape:
            ours *= max(1, d)
        theirs = 1
        for d in e.shape:
            theirs *= max(1, d)
        return e.median_s * (ours / theirs)

    def best_blocks(self, device: str, op: str,
                    shape: Iterable[int]) -> Optional[Tuple[int, ...]]:
        """Winning block config at the nearest bucket (None = untuned/default)."""
        shape = tuple(int(d) for d in shape)
        want = shape_bucket(shape)
        cands = [e for e in self.entries
                 if e.device == device and e.op == op
                 and len(e.bucket) == len(want)]
        if not cands:
            return None
        dmin = min(_bucket_dist(e.bucket, want) for e in cands)
        at_bucket = [e for e in cands if _bucket_dist(e.bucket, want) == dmin]
        winner = min(at_bucket, key=lambda e: (e.median_s, e.blocks or ()))
        return winner.blocks

    def fingerprint(self) -> str:
        """Stable content hash — joins the profiler's cost-cache key."""
        import hashlib
        blob = json.dumps([e.to_dict() for e in self.entries], sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- persistence --------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": TABLE_SCHEMA,
                "entries": [e.to_dict() for e in self.entries]}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LatencyTable":
        if int(d.get("schema", TABLE_SCHEMA)) > TABLE_SCHEMA:
            raise ValueError(
                f"latency table schema {d.get('schema')} is newer than "
                f"supported ({TABLE_SCHEMA})")
        return LatencyTable(KernelMeasurement.from_dict(e)
                            for e in d.get("entries", []))

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "LatencyTable":
        with open(path) as f:
            return LatencyTable.from_dict(json.load(f))

    def __len__(self) -> int:
        return len(self.entries)
