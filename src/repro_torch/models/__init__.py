"""Model families of the port (dense, MoE and SSM so far); see ``models.api``."""
from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
