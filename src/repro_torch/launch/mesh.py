"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py``.  FUNCTIONS, not module-level
constants — importing this module never touches device or process-group
state.  Single pod: 256 devices as (16, 16) with dims (data, model).
Multi-pod: (2, 16, 16) with a leading ``pod`` dim; per the paper's design
the ``pod`` dim carries only inter-op (pipeline) traffic.  Both are
``init_device_mesh`` over the ranks of the caller's initialised
``torch.distributed`` group, which must hold that many ranks.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """Arbitrary mesh for tests/examples (e.g. (2, 1, 1) over 2 ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
