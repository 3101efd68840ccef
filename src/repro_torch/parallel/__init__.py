"""Partition rules, host-side lowering of the planner's intra-op plans (no
device mesh yet), pipeline staging and the microbatch pipeline."""
from repro_torch.parallel import sharding
