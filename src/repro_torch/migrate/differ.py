"""Layout differ: old plan's holdings -> new plan's holdings, moved bytes
only.

For every byte a device must hold under the new layout:

1. if the *same physical device* already holds it under the old layout
   (and survived the fleet event), nothing moves — ``local_bytes``;
2. else the byte ships from the nearest surviving old holder — same node
   beats same sub-cluster beats cross-cluster (ties broken by device id,
   so the diff is deterministic);
3. a byte with no surviving holder (its replicas all sat on lost nodes)
   is restored from the newest checkpoint — ``src=None`` transfers,
   priced over the restore path instead of a fleet link.

Adjacent byte runs with the same (src, dst) pair merge into one
:class:`Transfer`, so the transfer set is minimal *and* small.  The
moved-bytes bound — ``moved_bytes`` equals the exact sum of live transfer
sizes, and no correct executor can ship fewer bytes to materialize the new
layout from the old one — is the invariant the property tests pin
(DESIGN.md §8).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.migrate.layout import (
    DeviceId, Interval, PlanLayout, intersect, length, normalize, subtract,
)


@dataclass(frozen=True)
class Transfer:
    """One contiguous byte run of one leaf moving to one device.
    ``src=None`` means no live replica survived: restore from checkpoint."""
    leaf: str
    start: int
    end: int                       # exclusive
    dst: DeviceId
    src: Optional[DeviceId] = None

    @property
    def nbytes(self) -> int:
        return self.end - self.start


@dataclass
class MigrationPlan:
    """The typed transfer set between two layouts plus exact byte
    accounting: ``moved_bytes`` (live device-to-device traffic),
    ``ckpt_bytes`` (checkpoint-restored), ``local_bytes`` (already in
    place), ``total_bytes`` (everything the new layout holds);
    ``moved + ckpt + local == total`` always."""
    transfers: List[Transfer] = field(default_factory=list)
    moved_bytes: int = 0
    ckpt_bytes: int = 0
    local_bytes: int = 0
    total_bytes: int = 0

    @property
    def n_transfers(self) -> int:
        return len(self.transfers)

    @property
    def moved_fraction(self) -> float:
        return self.moved_bytes / self.total_bytes if self.total_bytes else 0.0

    def describe(self) -> str:
        mb = 1e6
        return (f"migration: {self.moved_bytes / mb:.1f} MB moved in "
                f"{self.n_transfers} transfers, "
                f"{self.local_bytes / mb:.1f} MB in place, "
                f"{self.ckpt_bytes / mb:.1f} MB from checkpoint "
                f"({self.moved_fraction:.0%} of state on the wire)")


def _source_rank(lay_old: PlanLayout, src: DeviceId, dst: DeviceId) -> Tuple:
    """Preference key for choosing among surviving holders (lower wins):
    same node < same sub-cluster < cross-cluster, then device id for
    determinism."""
    if src[0] != dst[0]:
        return (3, src)
    dpn = lay_old.devices_per_node.get(src[0], 1)
    same_node = src[1] // dpn == dst[1] // dpn
    return (1 if same_node else 2, src)


def _cover(leaf: str, frag: Interval, dst: DeviceId,
           holders: List[Tuple[DeviceId, List[Interval]]],
           lay_old: PlanLayout) -> List[Transfer]:
    """Cover one missing fragment from the best overlapping holders: walk
    from ``frag.start``, at each position pick the preferred source whose
    interval covers it, and extend the transfer as far as that source
    goes.  Positions no holder covers become checkpoint restores."""
    out: List[Transfer] = []
    pos, end = frag
    while pos < end:
        best: Optional[Tuple[Tuple, DeviceId, int]] = None
        nxt = end                       # nearest upcoming holder start
        for dev, ivs in holders:
            for s, e in ivs:
                if s <= pos < e:
                    rank = _source_rank(lay_old, dev, dst)
                    if best is None or rank < best[0]:
                        best = (rank, dev, min(e, end))
                elif pos < s < nxt:
                    nxt = s
        if best is None:
            out.append(Transfer(leaf, pos, nxt, dst, src=None))
            pos = nxt
            continue
        _, dev, stop = best
        if out and out[-1].src == dev and out[-1].end == pos:
            out[-1] = Transfer(leaf, out[-1].start, stop, dst, src=dev)
        else:
            out.append(Transfer(leaf, pos, stop, dst, src=dev))
        pos = stop
    return out


def diff_layouts(old: PlanLayout, new: PlanLayout,
                 lost: Optional[Set[DeviceId]] = None) -> MigrationPlan:
    """The minimal transfer set turning ``old``'s holdings into ``new``'s
    (module docstring).  ``lost`` devices are excluded as sources — their
    bytes must come from surviving replicas or the checkpoint."""
    lost = lost or set()
    plan = MigrationPlan()
    for leaf, hold_new in new.holdings.items():
        hold_old = old.holdings.get(leaf, {})
        live = sorted(
            ((dev, ivs) for dev, ivs in hold_old.items() if dev not in lost),
            key=lambda kv: kv[0])
        for dst in sorted(hold_new):
            need = normalize(hold_new[dst])
            plan.total_bytes += length(need)
            already = intersect(need, hold_old.get(dst, [])) \
                if dst not in lost else []
            plan.local_bytes += length(already)
            for frag in subtract(need, already):
                for t in _cover(leaf, frag, dst, live, old):
                    plan.transfers.append(t)
                    if t.src is None:
                        plan.ckpt_bytes += t.nbytes
                    else:
                        plan.moved_bytes += t.nbytes
    return plan
