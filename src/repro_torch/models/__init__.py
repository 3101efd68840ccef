"""Model families of the port (dense, MoE, SSM, hybrid, VLM and audio); see
``models.api``."""
from repro_torch.models.api import (
    Model, build_model, cache_specs, input_specs, modality_inputs, param_specs,
)

__all__ = ["Model", "build_model", "cache_specs", "input_specs",
           "modality_inputs", "param_specs"]
