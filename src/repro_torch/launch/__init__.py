"""Launchers: the production meshes (``mesh``) and the deprecated
``train`` / ``serve`` shims over :mod:`repro_torch.api`."""
