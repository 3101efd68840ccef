"""User-facing entry points of the port: ``fit`` and ``generate``."""
from repro_torch.api.config import HarpConfig
from repro_torch.api.facade import fit, generate

__all__ = ["HarpConfig", "fit", "generate"]
