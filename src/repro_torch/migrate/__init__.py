"""Plan-to-plan live state migration (ROADMAP item 2).

``layout`` maps a (strategy, cluster) pair to per-device byte-interval
holdings of every parameter/optimizer leaf; ``differ`` emits the minimal
typed transfer set between two layouts; ``pricing`` prices it through the
comm subsystem's tiered links + fair-share netsim, overlapped with the old
plan's drain; ``apply`` is the host-side reference executor the
bit-identity tests run.

Front door used by the ElasticController and ``Executable.migrate_to``:

    old = layout_from_strategy(old_strategy, old_cluster, layers)
    new = layout_from_strategy(new_strategy, new_cluster, layers)
    mplan = diff_layouts(old, new, lost=lost_devices(old_cluster,
                                                     new_cluster))
    cost = price_migration(mplan, old, new_cluster,
                           old_strategy=old_strategy,
                           old_cluster=old_cluster, layers=layers)
    # cost.downtime_s -> amortization rule; mplan.moved_bytes -> decision
"""
from repro_torch.migrate.apply import (
    ApplyStats, MigrationAborted, RetryPolicy, ShardedState, apply_migration,
    gather_leaf, shard_state, states_equal,
)
from repro_torch.migrate.differ import MigrationPlan, Transfer, diff_layouts
from repro_torch.migrate.layout import (
    DeviceId, LeafSpec, PlanLayout, layout_from_strategy, lost_devices,
    stage_devices, stage_intra,
)
from repro_torch.migrate.pricing import (
    DEFAULT_RESTORE_BW, MigrationCost, classify_link, price_migration,
)

__all__ = [
    "ApplyStats", "DeviceId", "LeafSpec", "MigrationAborted", "MigrationCost",
    "MigrationPlan", "PlanLayout", "RetryPolicy", "ShardedState", "Transfer",
    "apply_migration",
    "classify_link", "diff_layouts", "gather_leaf", "layout_from_strategy",
    "lost_devices", "price_migration", "shard_state", "stage_devices",
    "stage_intra", "states_equal", "DEFAULT_RESTORE_BW",
]
