"""User-facing entry points of the port (serving so far)."""
from repro_torch.api.facade import generate

__all__ = ["generate"]
