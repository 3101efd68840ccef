"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA H100.

The port imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``:
it keeps its own copies of what it needs (``repro_torch.configs``).  Module
names follow the reference, so ``repro.models.attention`` has its
counterpart in ``repro_torch.models.attention``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
