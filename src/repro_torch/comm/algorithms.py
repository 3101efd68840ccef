"""Collective algorithm zoo: closed-form allreduce costs over a topology.

Each algorithm prices one allreduce of ``nbytes`` over a
:class:`~repro_torch.comm.topology.CommGroup` and reports both the wall-clock
seconds and the per-link occupancy (the seconds each named link is busy —
what :mod:`repro_torch.comm.netsim` turns into contention and
``LoweredPlan.link_occupancy_s`` records).

The zoo (all bandwidth terms use the classic cost model, latency terms count
link startups on the critical path):

- ``ring`` — flat ring over all ranks.  Bandwidth-optimal
  (``2(N-1)/N * B / bw``) but paced by the *slowest* link in the group with
  the *full* payload, and it pays ``2(N-1)`` latencies.  On a single uniform
  tier this is exactly the legacy scalar pricing
  (``bytes * 2(N-1)/N / bw``, no latency on intra-cluster links).
- ``rhd`` — recursive halving-doubling.  Same bandwidth term, only
  ``2*log2(N)`` latencies; needs a power-of-two rank count.  Wins on small,
  latency-dominated payloads (e.g. scalar syncs across the WAN).
- ``hierarchical`` — the two-level (generally multi-level) reduce:
  reduce-scatter each inner tier on its fast link, allreduce the outermost
  tier on the slow link with the payload already divided by the inner
  domain sizes, then allgather back out.  The slow link carries ``1/prod
  (inner sizes)`` of the payload — this is HETHUB's cross-cluster
  hierarchy, and it wins exactly when the outer link is much slower
  (paper Fig. 10's low cross-bandwidth regime).

Third-party algorithms register by name here (or through
``repro.api.registry``'s ``"collective"`` kind, which delegates to this
table) and become selectable via ``CommConfig.algorithms``.

Units: bytes, bytes/s, seconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.comm.topology import CommGroup


@dataclass(frozen=True)
class CollectiveCost:
    """One priced collective: wall seconds + per-link busy seconds."""
    seconds: float
    link_busy: Dict[str, float] = field(default_factory=dict)


class CollectiveAlgorithm:
    """Interface: ``supports`` guards structural requirements (tier count,
    power-of-two ranks); ``cost`` is the closed form.  Subclass + register
    to extend the zoo."""

    name: str = "?"

    def supports(self, group: CommGroup) -> bool:
        raise NotImplementedError

    def cost(self, group: CommGroup, nbytes: float) -> CollectiveCost:
        raise NotImplementedError


def _busy_all(group: CommGroup, seconds: float) -> Dict[str, float]:
    """Flat algorithms keep every participating link occupied for the whole
    collective (the ring/butterfly is pipelined across all of them)."""
    return {l.name: seconds for _, l in group.tiers}


class RingAllReduce(CollectiveAlgorithm):
    name = "ring"

    def supports(self, group: CommGroup) -> bool:
        return True

    def cost(self, group: CommGroup, nbytes: float) -> CollectiveCost:
        g = group.effective()
        n = g.n_ranks
        if n <= 1:
            return CollectiveCost(0.0)
        bw = g.bottleneck.bandwidth
        secs = nbytes * 2.0 * (n - 1) / n / bw + 2.0 * (n - 1) * g.max_latency
        return CollectiveCost(secs, _busy_all(g, secs))


class RecursiveHalvingDoubling(CollectiveAlgorithm):
    name = "rhd"

    def supports(self, group: CommGroup) -> bool:
        n = group.effective().n_ranks
        return n >= 1 and (n & (n - 1)) == 0

    def cost(self, group: CommGroup, nbytes: float) -> CollectiveCost:
        g = group.effective()
        n = g.n_ranks
        if n <= 1:
            return CollectiveCost(0.0)
        bw = g.bottleneck.bandwidth
        log2n = n.bit_length() - 1
        secs = nbytes * 2.0 * (n - 1) / n / bw + 2.0 * log2n * g.max_latency
        return CollectiveCost(secs, _busy_all(g, secs))


class TwoLevelHierarchical(CollectiveAlgorithm):
    """Reduce-scatter inward, allreduce the outermost tier, allgather
    outward — each phase priced as a ring on its own tier's link."""

    name = "hierarchical"

    def supports(self, group: CommGroup) -> bool:
        return len(group.effective().tiers) >= 2

    def cost(self, group: CommGroup, nbytes: float) -> CollectiveCost:
        g = group.effective()
        tiers = g.tiers
        busy: Dict[str, float] = {}
        secs = 0.0
        remaining = float(nbytes)
        # inner tiers: reduce-scatter + (later) allgather, payload shrinking
        for size, link in tiers[:-1]:
            phase = (remaining * (size - 1) / size / link.bandwidth
                     + (size - 1) * link.latency)
            secs += 2.0 * phase                 # rs in, ag out
            busy[link.name] = busy.get(link.name, 0.0) + 2.0 * phase
            remaining /= size
        size, link = tiers[-1]
        ar = (remaining * 2.0 * (size - 1) / size / link.bandwidth
              + 2.0 * (size - 1) * link.latency)
        secs += ar
        busy[link.name] = busy.get(link.name, 0.0) + ar
        return CollectiveCost(secs, busy)


# ---------------------------------------------------------------------------
# Registry (repro.api.registry's "collective" kind delegates here, so core
# code never has to import the api package)
# ---------------------------------------------------------------------------

ALGORITHMS: Dict[str, CollectiveAlgorithm] = {}


def register_collective(name: str, algo: CollectiveAlgorithm, *,
                        overwrite: bool = False) -> CollectiveAlgorithm:
    if name in ALGORITHMS and not overwrite:
        raise ValueError(
            f"collective {name!r} already registered (pass overwrite=True)")
    ALGORITHMS[name] = algo
    return algo


def get_algorithm(name: str) -> CollectiveAlgorithm:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise KeyError(f"unknown collective {name!r}; available: "
                       f"{available_collectives()}") from None


def available_collectives() -> List[str]:
    return sorted(ALGORITHMS)


register_collective("ring", RingAllReduce())
register_collective("rhd", RecursiveHalvingDoubling())
register_collective("hierarchical", TwoLevelHierarchical())
