"""``repro_torch.comm`` — heterogeneity-aware collective communication.

Four pieces (see docs/comm.md for the walkthrough):

- :mod:`repro_torch.comm.topology` — the fleet's typed link graph (nvlink / pcie /
  ib / wan tiers) with a cache-keying fingerprint;
- :mod:`repro_torch.comm.algorithms` — the collective algorithm zoo (flat ring,
  recursive halving-doubling, two-level hierarchical) with closed-form costs
  over a topology, extensible by name;
- :mod:`repro_torch.comm.netsim` — the event-driven fair-share link-occupancy
  simulator (concurrent transfers on a shared link slow each other down);
- :mod:`repro_torch.comm.selector` — per-collective algorithm auto-selection
  (:class:`CommModel`) the planner prices stages with, plus the plan-side
  collective breakdown the api facade reports.

Everything here is numpy-or-lighter at import time; jax is only touched
lazily when int8 compression is exercised end-to-end.
"""
from repro_torch.comm.algorithms import (
    ALGORITHMS, CollectiveAlgorithm, CollectiveCost, available_collectives,
    get_algorithm, register_collective,
)
from repro_torch.comm.netsim import NetSimResult, SimNode, price_transfers, run
from repro_torch.comm.selector import (
    CommConfig, CommModel, Selection, boundary_link_ids,
    collective_breakdown, compressed_wire_bytes, stage_sync_seconds,
)
from repro_torch.comm.topology import (
    CommGroup, Link, Topology, build_topology, fingerprint,
)

__all__ = [
    "ALGORITHMS", "CollectiveAlgorithm", "CollectiveCost",
    "available_collectives", "get_algorithm", "register_collective",
    "NetSimResult", "SimNode", "price_transfers", "run",
    "CommConfig", "CommModel", "Selection", "boundary_link_ids",
    "collective_breakdown", "compressed_wire_bytes", "stage_sync_seconds",
    "CommGroup", "Link", "Topology", "build_topology", "fingerprint",
]
