"""Partition rules and their placements on a ``torch.distributed``
``DeviceMesh``, the lowering of the planner's intra-op plans to meshes,
int8 gradient compression, pipeline staging and the microbatch pipeline."""
from repro_torch.parallel import sharding
