"""Host-side lowering of the planner's intra-op plans (no device mesh yet)."""
from repro_torch.parallel import sharding
