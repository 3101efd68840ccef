"""Model families of the port (dense, MoE, SSM, hybrid, VLM and audio); see
``models.api``."""
from repro_torch.models.api import Model, build_model, modality_inputs

__all__ = ["Model", "build_model", "modality_inputs"]
